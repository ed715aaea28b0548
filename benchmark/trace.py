"""The traced window's arithmetic: the profiler around whole chunks of the
run, device time by op and by layer, and the device's idle share.

Frozen copies, so that a change to the program cannot move the yardstick:

- `Profiler` is `nlos_gaussian_renderer_tpu_torch/tools/fitbench.py:
  profile_chunk` (commit 698b441): `torch.profiler` over CPU and CUDA, a
  spin kernel first, left out of every count, since the profiler has
  dropped a window's first device event on the H100. Here spin kernels
  also mark the window's ends on the device's clock.
- `op_durations`, `_Frames` and `kernel_layers` are `tools/trace_report.py`'s
  `op_durations`, `_Frames` and `kernel_sources` (same commit): a device
  event is charged through its launch (the runtime call of its correlation
  id) to the package frames open there, and a launch from autograd's C++
  engine to the frames of the forward op that shares its sequence number.
  Where `kernel_sources` names the innermost frame, `kernel_layers` charges
  the event to the first layer of `benchmark/layers.json` whose functions
  appear among all the open frames, so a helper inside a layer's entry
  function stays in that layer.
- Busy time is the union of the device intervals (kernels, copies, fills)
  inside the window, not the sum of their durations, so the idle share
  cannot fall below 0.

A CUDA graph replays its kernels from one launch, with no frames: the
replayed window's ops are charged to layers in the shares that an eager
twin (the same step, run eagerly under the profiler with stacks) gives
each op's name, and an op the twin never ran by `layers.json`'s kernel
names.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op",)
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
PACKAGE = "nlos_gaussian_renderer_tpu_torch"
PLUMBING = ("ops/cuda_build.py",)
SPIN = "spin_kernel"
LAYERS_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "layers.json")


def load_layers(path: str = LAYERS_FILE) -> list:
    with open(path) as f:
        return json.load(f)["layers"]


class Profiler:
    """`start()` / `stop()` around a stretch of the run; `stop()` returns
    the Chrome trace as a dict. Spin kernels of `spin_cycles` mark the ends
    (two at the start: the first may be dropped)."""

    def __init__(self, with_stack: bool = False, spin_cycles: int = 1000):
        self.with_stack, self.spin = with_stack, spin_cycles
        self._prof = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                             with_stack=self.with_stack)
        self._prof.start()
        torch.cuda._sleep(self.spin)
        torch.cuda._sleep(self.spin)
        torch.cuda.synchronize()

    def stop(self) -> dict:
        torch.cuda._sleep(self.spin)
        torch.cuda.synchronize()
        self._prof.stop()
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                trace = json.load(f)
        self._prof = None
        return trace


def _complete(trace: dict, cats):
    return [e for e in trace.get("traceEvents", [])
            if e.get("ph") == "X" and "dur" in e and e.get("cat") in cats]


def device_events(trace: dict) -> list:
    """The device events of the trace, spin kernels left out."""
    return [e for e in _complete(trace, DEVICE_CATS) if SPIN not in e["name"]]


def window_bounds(trace: dict):
    """(start, end) in us: the end of the last spin kernel before the first
    other device event, the start of the first spin kernel after the last
    one."""
    spins = sorted((e for e in _complete(trace, DEVICE_CATS) if SPIN in e["name"]),
                   key=lambda e: e["ts"])
    ev = device_events(trace)
    if not ev or not spins:
        return None
    first = min(e["ts"] for e in ev)
    last = max(e["ts"] + e["dur"] for e in ev)
    before = [s["ts"] + s["dur"] for s in spins if s["ts"] + s["dur"] <= first]
    after = [s["ts"] for s in spins if s["ts"] >= last]
    return (max(before) if before else first, min(after) if after else last)


def busy_us(events, t0: float, t1: float) -> float:
    """Length of the union of the events' intervals inside [t0, t1]."""
    iv = sorted((max(e["ts"], t0), min(e["ts"] + e["dur"], t1)) for e in events)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in iv:
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def op_durations(events) -> collections.Counter:
    """Total duration (us) per event name."""
    agg = collections.Counter()
    for e in events:
        agg[e["name"]] += e["dur"]
    return agg


def idle_gaps(trace: dict, t0: float, t1: float, top: int = 10) -> list:
    """The longest stretches of [t0, t1] with no device event, each named
    by the longest host op or runtime call running at its middle: [[name,
    seconds], ...]."""
    ev = sorted(device_events(trace), key=lambda e: e["ts"])
    host = _complete(trace, HOST_CATS + LAUNCH_CATS)
    gaps, cur = [], t0
    for e in ev:
        if e["ts"] > cur:
            gaps.append((cur, e["ts"]))
        cur = max(cur, e["ts"] + e["dur"])
    if t1 > cur:
        gaps.append((cur, t1))
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for s, e in gaps[:top]:
        mid = 0.5 * (s + e)
        around = [h for h in host if h["ts"] <= mid <= h["ts"] + h["dur"]]
        name = max(around, key=lambda h: h["dur"])["name"] if around else "(host, no op)"
        out.append([name, (e - s) / 1e6])
    return out


class _Frames:
    """The package's Python frames of one trace, by (pid, tid): `stacks(events)`
    gives, for each event, the frames open at its start, outermost first
    (one sweep a thread: frames nest, so the open ones form a stack)."""

    def __init__(self, trace: dict, package: str = PACKAGE):
        by_thread = collections.defaultdict(list)
        for e in _complete(trace, ("python_function",)):
            if package in e["name"] and not any(p in e["name"] for p in PLUMBING):
                by_thread[(e["pid"], e["tid"])].append((e["ts"], e["ts"] + e["dur"], e["name"]))
        self._frames = {k: sorted(v, key=lambda f: (f[0], -f[1]))
                        for k, v in by_thread.items()}

    def stacks(self, events) -> dict:
        out = {}
        by_thread = collections.defaultdict(list)
        for e in events:
            by_thread[(e["pid"], e["tid"])].append(e)
        for key, evs in by_thread.items():
            frames = self._frames.get(key, [])
            stack, j = [], 0
            for e in sorted(evs, key=lambda e: e["ts"]):
                ts = e["ts"]
                while j < len(frames) and frames[j][0] <= ts:
                    while stack and stack[-1][1] < frames[j][0]:
                        stack.pop()
                    stack.append(frames[j])
                    j += 1
                while stack and stack[-1][1] < ts:
                    stack.pop()
                out[id(e)] = [f[2][f[2].find(PACKAGE):] for f in stack if f[1] >= ts]
        return out


def frame_function(frame: str):
    """(file under the package, function) of a frame name
    'pkg/ops/x.py(12): fn'."""
    path, _, fn = frame.partition("): ")
    path = path.rsplit("(", 1)[0]
    return path[len(PACKAGE) + 1:] if path.startswith(PACKAGE) else path, fn


def classify(frames, layers: list) -> str:
    """The first layer of `layers` that claims one of `frames`: by function
    name anywhere in the stack, then by an autograd method (`forward`,
    `backward`) of one of the layer's files; else the default layer."""
    parsed = [frame_function(f) for f in frames]
    for layer in layers:
        if any(fn in layer.get("functions", ()) for _, fn in parsed):
            return layer["layer"]
    for layer in layers:
        if any(fn in ("forward", "backward") and path in layer.get("autograd_files", ())
               for path, fn in parsed):
            return layer["layer"]
    return next(layer["layer"] for layer in layers if layer.get("default"))


def kernel_layers(trace: dict, layers: list) -> dict:
    """{op name: Counter(layer: us)}: each device event charged through its
    launch to the layer of the frames open there (`classify`), a launch
    with no frame through the forward op of its sequence number, else to
    '(no frame)'."""
    launches = {}
    for e in _complete(trace, LAUNCH_CATS):
        cid = e.get("args", {}).get("correlation")
        if cid is not None:
            launches[cid] = e
    ops = sorted(_complete(trace, HOST_CATS), key=lambda e: e["ts"])
    stacks = _Frames(trace).stacks(list(launches.values()) + ops)
    forward_of = {}
    for e in ops:
        seq = e.get("args", {}).get("Sequence number")
        if seq is not None and seq not in forward_of:
            forward_of[seq] = e
    ops_by_thread = collections.defaultdict(list)
    for e in ops:
        ops_by_thread[(e["pid"], e["tid"])].append(e)
    starts = {k: [e["ts"] for e in v] for k, v in ops_by_thread.items()}

    def via_sequence(anchor):
        key = (anchor["pid"], anchor["tid"])
        lst = ops_by_thread.get(key, [])
        for i in range(bisect.bisect_right(starts.get(key, []), anchor["ts"]) - 1, -1, -1):
            op = lst[i]
            if op["ts"] + op["dur"] < anchor["ts"]:
                continue
            fwd = forward_of.get(op.get("args", {}).get("Sequence number"))
            if fwd is not None and fwd is not op and stacks.get(id(fwd)):
                return stacks[id(fwd)]
        return None

    out = collections.defaultdict(collections.Counter)
    for e in device_events(trace):
        anchor = launches.get(e.get("args", {}).get("correlation"))
        st = None
        if anchor is not None:
            st = stacks.get(id(anchor)) or via_sequence(anchor)
        out[e["name"]][classify(st, layers) if st else "(no frame)"] += e["dur"]
    return dict(out)


def by_kernel_name(name: str, layers: list) -> str:
    """The layer whose kernel names appear in an op's name, else the
    default layer."""
    for layer in layers:
        if any(k in name for k in layer.get("kernels", ())):
            return layer["layer"]
    return next(layer["layer"] for layer in layers if layer.get("default"))


def layer_us(durations: collections.Counter, twin: dict, layers: list) -> dict:
    """{layer: us} of a replayed window's op durations, each op split in the
    shares its name has in the eager twin (`kernel_layers`), by its kernel
    name where the twin never ran it or had no frame for it."""
    out = collections.Counter()
    for name, us in durations.items():
        shares = {k: v for k, v in twin.get(name, {}).items() if k != "(no frame)"}
        total = sum(shares.values())
        if total <= 0:
            out[by_kernel_name(name, layers)] += us
            continue
        for layer, v in shares.items():
            out[layer] += us * v / total
    return dict(out)


def summarise(window_trace: dict, twin_trace, steps: int, layers: list) -> dict:
    """Everything the per-layer readers take from a traced window of `steps`
    steps and its eager twin: window and busy seconds, device ms a step,
    ms a step by layer, the top device ops and the longest idle gaps."""
    bounds = window_bounds(window_trace)
    ev = device_events(window_trace)
    if bounds is None:
        return dict(window_s=None, busy_s=None, device_ms_per_step=None, layers_ms={},
                    device_ops=[], idle_gaps=[])
    t0, t1 = bounds
    busy = busy_us(ev, t0, t1)
    durs = op_durations(e for e in ev if t0 <= e["ts"] <= t1)
    twin = kernel_layers(twin_trace, layers) if twin_trace is not None else {}
    per_layer = layer_us(durs, twin, layers)
    return dict(window_s=(t1 - t0) / 1e6, busy_s=busy / 1e6,
                device_ms_per_step=busy / 1e3 / steps,
                layers_ms={k: v / 1e3 / steps for k, v in per_layer.items()},
                device_ops=[[n, us / 1e6] for n, us in durs.most_common(10)],
                idle_gaps=idle_gaps(window_trace, t0, t1))
