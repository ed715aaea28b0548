"""Profiling and step-timing utilities.

Port of `nlos_gaussian_renderer_tpu/utils/profiling.py`: a `torch.profiler`
trace context (a Chrome trace where JAX writes an xprof trace), the rolling
step timer, and the card's memory statistics.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional

import torch


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
        self.total_steps = 0
        self.total_time = 0.0

    def tick(self, n: int = 1) -> Optional[Dict[str, float]]:
        """Count n steps; returns stats every `window` steps, else None."""
        self._count += n
        self.total_steps += n
        if self._count >= self.window:
            dt = time.perf_counter() - self._t0
            self.total_time += dt
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
