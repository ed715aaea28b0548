"""Profiling, tracing and step-timing utilities.

Port of `nlos_gaussian_renderer_tpu/utils/profiling.py`: a `torch.profiler`
trace context (a Chrome trace where JAX writes an xprof trace), the rolling
step timer, and the card's memory statistics. Beside them, the port's own
tracing: spans and counters at the boundaries of `train.fit`, its overflow
gate, its chunk and the kernel build.

Tracing has one switch, `enable_tracing`, off by default. Off, `span` and
`count` return after one test of a module-level flag and `device_counter`
returns None: nothing is recorded, no tensor is made, nothing enters a
CUDA graph. On:

- `span(name)` records (name, parent, start, end) on `time.perf_counter`
  in memory, the parent being the span open around it on the same
  thread. While a `torch.profiler` records, it also opens a
  `torch.profiler.record_function` of the same name, so the span lies in
  the Chrome trace (category `user_annotation`) on the device trace's
  clock. A span adds no synchronize: one over device work ends at a host
  read the code already makes.
- `count(name, n)` and `Counts.add` add to the host counters.
- `device_counter(name, device)` is an int64 tensor that kernels add into
  on the device (a launch captured into a CUDA graph adds on every
  replay). It is made at first use, which must come before any capture
  (a fill recorded into a graph would reset it on every replay), and is
  read only by `snapshot`. It is not part of the train state: every run
  of the counting code adds, a capture's warm-up run and a chunk that the
  overflow gate runs again from its snapshot included.

`snapshot()` returns the spans and counters (a host read of each device
counter: call it where the device has been waited for), `reset()` clears
them. A graph captured while tracing was on keeps its counting launches;
`train.ScannedTrainStep` captures again when the switch has moved.
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
from typing import Dict, Iterator, Optional

import torch

_on = False
_spans: list = []  # [name, parent index or -1, start, end] on perf_counter
_open = threading.local()  # .stack: indices of the spans open on this thread
_counters: collections.Counter = collections.Counter()
_device_counters: Dict[tuple, torch.Tensor] = {}  # (name, device) -> int64 (1,)


def enable_tracing(on: bool = True) -> None:
    """Switch the port's spans and counters on or off (off by default)."""
    global _on
    _on = bool(on)


def tracing() -> bool:
    return _on


class _Off:
    """The context `span` returns while tracing is off: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("_rec", "_fn")

    def __init__(self, name: str):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self._rec = [name, stack[-1] if stack else -1, 0.0, None]
        self._fn = None

    def __enter__(self):
        if torch.autograd._profiler_enabled():
            self._fn = torch.profiler.record_function(self._rec[0])
            self._fn.__enter__()
        _open.stack.append(len(_spans))
        _spans.append(self._rec)
        self._rec[2] = time.perf_counter()
        return None

    def __exit__(self, *exc):
        self._rec[3] = time.perf_counter()
        _open.stack.pop()
        if self._fn is not None:
            self._fn.__exit__(*exc)
        return False


def span(name: str):
    """A context that records the span `name` while tracing is on."""
    if not _on:
        return _OFF
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add `n` to the host counter `name` while tracing is on."""
    if not _on:
        return
    _counters[name] += n


class Counts(collections.Counter):
    """Event counts that their owner keeps whether tracing is on or not
    (a gate's re-tunes, its chunks' captures and replays): `add` counts an
    event here and, while tracing is on, in the host counters."""

    def add(self, name: str, n: int = 1) -> None:
        self[name] += n
        count(name, n)


def device_counter(name: str, device) -> Optional[torch.Tensor]:
    """The (1,) int64 counter `name` on `device` while tracing is on, made
    at its first use (never under a CUDA graph capture); None when off."""
    if not _on:
        return None
    dev = torch.device(device)
    t = _device_counters.get((name, dev))
    if t is None:
        if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"device counter {name!r} first used under a CUDA graph "
                               "capture: run the step once before capturing it")
        t = _device_counters[(name, dev)] = torch.zeros(1, dtype=torch.int64, device=dev)
    return t


def snapshot() -> dict:
    """{'spans': [{'name', 'parent' (index in the list, -1 for none),
    'start', 'end' (None while open)}], 'counters': {name: int}}: the host
    counters and each device counter summed over its devices (a host read
    of each: it waits for the work queued before it)."""
    counters = dict(_counters)
    for (name, _), t in _device_counters.items():
        counters[name] = counters.get(name, 0) + int(t.item())
    return dict(spans=[dict(name=n, parent=p, start=s, end=e) for n, p, s, e in _spans],
                counters=counters)


def reset() -> None:
    """Clear the spans and the host counters, and zero the device counters
    in place (a captured graph may still add into them)."""
    _spans.clear()
    _counters.clear()
    for t in _device_counters.values():
        t.zero_()


@contextlib.contextmanager
def trace(log_dir: str, with_stack: bool = False) -> Iterator[None]:
    """Profile the block (host and, where there is a card, device
    activity) and write `log_dir/trace.json`, a Chrome trace (open it in
    Perfetto or chrome://tracing; `tools/trace_report.py` sums it). With
    `with_stack` the trace also holds the Python frames, from which
    `trace_report --by-source` maps each op to the function that
    launched it."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts, with_stack=with_stack) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Rolling throughput meter for the training loop."""

    def __init__(self, window: int = 100):
        self.window = window
        self.reset()

    def reset(self) -> None:
        self._t0 = time.perf_counter()
        self._count = 0

    def tick(self, n: int = 1) -> Optional[Dict[str, float]]:
        """Count n steps; returns stats every `window` steps, else None."""
        self._count += n
        if self._count >= self.window:
            dt = time.perf_counter() - self._t0
            stats = {
                "iters_per_sec": self._count / max(dt, 1e-9),
                "ms_per_iter": dt / self._count * 1e3,
                "window_sec": dt,
            }
            self._t0 = time.perf_counter()
            self._count = 0
            return stats
        return None


def device_memory_stats() -> Dict[str, float]:
    """Per-card memory in GiB, `cuda:<i>:bytes_in_use_gib` and
    `cuda:<i>:peak_gib` (PyTorch's caching allocator); empty without a
    card."""
    out: Dict[str, float] = {}
    if not torch.cuda.is_available():
        return out
    gib = 1024**3
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        if not s:
            continue
        out[f"cuda:{i}:bytes_in_use_gib"] = s.get("allocated_bytes.all.current", 0) / gib
        out[f"cuda:{i}:peak_gib"] = s.get("allocated_bytes.all.peak", 0) / gib
    return out
