"""Device time by op, and by the source that launched it, from a Chrome
trace: the counterpart of the JAX repo's `tools/trace_report.py`, with the
job of its `tools/hlo_report.py` (which maps XLA fusions to source lines).

It reads the `trace.json` that `utils/profiling.trace(log_dir)` writes
(a `torch.profiler` Chrome trace; JAX's tool reads xprof's
`*.trace.json.gz`) and prints each op's total per step: device kernels,
copies and fills (`--cpu-ops`: the host's aten ops, for a CPU trace).

`--by-source` maps each op to the functions of the package that launched
it, from a trace taken with `trace(log_dir, with_stack=True)`: a kernel's
launch (the runtime call with its correlation id) lies inside Python
frames, and the innermost frame in the package (past the kernel registry's generic
launcher) names it, as torch records
a frame (file, the function's first line, its name). A launch from
autograd's C++ engine (a built-in op's backward) has no Python frame: it
goes to "backward of" its forward op's frame, through the ops' sequence
numbers. A CUDA graph replays its kernels from one launch, so a replayed
chunk's sources come from another trace of the same step run eagerly:
`--sources EAGER_TRACE_DIR`.

    python -m nlos_gaussian_renderer_tpu_torch.tools.trace_report TRACE_DIR \\
        [--steps N] [--top 30] [--by-source [--sources DIR]] [--cpu-ops]
"""

from __future__ import annotations

import argparse
import bisect
import collections
import json
import os

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op",)
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
PACKAGE = "nlos_gaussian_renderer_tpu_torch"
# Frames that every kernel launch passes through (the kernel registry's
# generic launcher): a launch is charged to its caller instead.
PLUMBING = ("ops/cuda_build.py",)


def load_trace(path: str) -> dict:
    """The Chrome trace at `path`: a file, or a directory holding
    `trace.json`."""
    if os.path.isdir(path):
        path = os.path.join(path, "trace.json")
    with open(path) as f:
        return json.load(f)


def _complete(trace: dict, cats):
    return [e for e in trace.get("traceEvents", [])
            if e.get("ph") == "X" and "dur" in e and e.get("cat") in cats]


def op_durations(trace: dict, cats=DEVICE_CATS) -> collections.Counter:
    """Total duration (us) per event name over the complete events of
    categories `cats`."""
    agg = collections.Counter()
    for e in _complete(trace, cats):
        agg[e["name"]] += e["dur"]
    return agg


class _Frames:
    """The package's Python frames of one trace, by (pid, tid), sorted by
    start: `innermost(pid, tid, ts)` is the latest-starting frame open at
    `ts`."""

    def __init__(self, trace: dict, package: str):
        by_thread = collections.defaultdict(list)
        for e in _complete(trace, ("python_function",)):
            if package in e["name"] and not any(p in e["name"] for p in PLUMBING):
                by_thread[(e["pid"], e["tid"])].append((e["ts"], e["ts"] + e["dur"], e["name"]))
        self._frames = {k: sorted(v) for k, v in by_thread.items()}
        self._starts = {k: [f[0] for f in v] for k, v in self._frames.items()}

    def innermost(self, pid, tid, ts):
        frames = self._frames.get((pid, tid))
        if not frames:
            return None
        for i in range(bisect.bisect_right(self._starts[(pid, tid)], ts) - 1, -1, -1):
            start, end, name = frames[i]
            if end >= ts:
                return name[name.find(PACKAGE):] if PACKAGE in name else name
        return None


def kernel_sources(trace: dict, cats=DEVICE_CATS, package: str = PACKAGE) -> dict:
    """{op name: Counter(source: us)}: each event of `cats` charged to the
    innermost frame of `package` open at its launch (a device event's
    launch is the runtime call of the same correlation id; a host op is its
    own launch), else to "backward of" the frame of the forward op that
    shares its sequence number, else to "(no frame)"."""
    frames = _Frames(trace, package)
    launches = {}
    for e in _complete(trace, LAUNCH_CATS):
        cid = e.get("args", {}).get("correlation")
        if cid is not None:
            launches[cid] = e
    ops = sorted(_complete(trace, HOST_CATS), key=lambda e: e["ts"])
    forward_of = {}  # sequence number -> the first op that carries it
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
            seq = op.get("args", {}).get("Sequence number")
            fwd = forward_of.get(seq)
            if fwd is not None and fwd is not op:
                src = frames.innermost(fwd["pid"], fwd["tid"], fwd["ts"])
                if src is not None:
                    return f"backward of {src}"
        return None

    out = collections.defaultdict(collections.Counter)
    for e in _complete(trace, cats):
        anchor = e
        if e.get("cat") in DEVICE_CATS:
            anchor = launches.get(e.get("args", {}).get("correlation"))
        src = None
        if anchor is not None:
            src = frames.innermost(anchor["pid"], anchor["tid"], anchor["ts"])
            if src is None:
                src = via_sequence(anchor)
        out[e["name"]][src or "(no frame)"] += e["dur"]
    return dict(out)


def report(trace: dict, steps: int = 1, top: int = 30, by_source: bool = False,
           sources_trace=None, cats=DEVICE_CATS) -> list:
    """The `top` ops by total time: [{name, ms_per_step, count, sources:
    [[source, share of the op's time], ...]}]; the sources from
    `sources_trace` where given (a replayed graph's eager twin)."""
    agg = op_durations(trace, cats)
    counts = collections.Counter(e["name"] for e in _complete(trace, cats))
    srcs = kernel_sources(sources_trace or trace, cats) if by_source else {}
    rows = []
    for name, us in agg.most_common(top):
        row = {"name": name, "ms_per_step": us / steps / 1e3,
               "count_per_step": counts[name] / steps}
        if by_source:
            by = srcs.get(name, collections.Counter())
            total = sum(by.values()) or 1.0
            row["sources"] = [[s, v / total] for s, v in by.most_common(3)]
        rows.append(row)
    return rows


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trace_dir")
    ap.add_argument("--steps", type=int, default=1, help="divide totals by this step count")
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--by-source", action="store_true",
                    help="map each op to the package function that launched it")
    ap.add_argument("--sources", default=None,
                    help="take the sources from this trace (an eager run of the same step)")
    ap.add_argument("--cpu-ops", action="store_true", help="the host's aten ops")
    args = ap.parse_args(argv)
    cats = HOST_CATS if args.cpu_ops else DEVICE_CATS
    rows = report(load_trace(args.trace_dir), args.steps, args.top, args.by_source,
                  load_trace(args.sources) if args.sources else None, cats)
    print(f"{'ms/step':>10} {'n/step':>7}  op")
    for r in rows:
        print(f"{r['ms_per_step']:10.4f} {r['count_per_step']:7.1f}  {r['name'][:110]}")
        for src, share in r.get("sources", []):
            print(f"{'':19}{share:6.1%}  {src}")
    return rows


if __name__ == "__main__":
    main()
