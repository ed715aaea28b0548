"""The port's own spans and counters (`nlos_gaussian_renderer_tpu_torch/
utils/profiling.py`) read against a traced window: the device's idle time
split by what the host was doing, the cull's listed pairs over the useful
ones, and the set-up's rework.

- `host_idle`: a stretch of the window with no device event is host-bound
  when the device event that ends it had not been handed over when it
  began: that event is the first of its launch (the runtime call of its
  correlation id; a graph's kernels carry their `cudaGraphLaunch`'s) and
  the call ended after the stretch opened. Any other stretch is idle with
  work queued: between the kernels of one graph, or behind a launch that
  had returned. Host-bound time is charged to the innermost program span
  (a `user_annotation` event of the trace) open over each part of it.
- `waste_ratio`: the device counter `cull.listed_pairs` over the window,
  a step, over the useful pairs a step (`benchmark/work.py`).
- `rework_s`: the seconds of `chunk.capture`, `gate.retune` and
  `gate.overflow_replay` spans (outermost, so none counts twice) that
  ended before the window opened;
- `rework_share`: the host time of the same spans opened inside the
  traced window (up to its close), over the window, in %;
- `window_counts`: what the port's host counters of the gate and the
  chunk (`COUNTED`) added over the window.

Every reader takes what the port recorded and returns None where it
recorded nothing (a program without the spans or the counter).
"""

from __future__ import annotations

import bisect
import collections

from benchmark import trace as btrace

SPAN_CAT = "user_annotation"
REWORK = ("chunk.capture", "gate.retune", "gate.overflow_replay")
LISTED = "cull.listed_pairs"
COUNTED = ("gate.retunes", "gate.overflow_replays", "chunk.captures", "chunk.densify_replays")
NO_SPAN = "(no span)"


def idle_stretches(window_trace: dict, t0: float, t1: float) -> list:
    """[(start, end, host_bound)] in us: the stretches of [t0, t1] with no
    device event (spin kernels left out, as `device.idle_share`), each
    judged by the device event, spin kernels included, that ends it."""
    ev = sorted(btrace.device_events(window_trace), key=lambda e: e["ts"])
    every = sorted(btrace._complete(window_trace, btrace.DEVICE_CATS), key=lambda e: e["ts"])
    starts = [e["ts"] for e in every]
    launch_end, first_of = {}, {}
    for e in btrace._complete(window_trace, btrace.LAUNCH_CATS):
        cid = e.get("args", {}).get("correlation")
        if cid is not None:
            launch_end[cid] = e["ts"] + e["dur"]
    for e in every:
        first_of.setdefault(e.get("args", {}).get("correlation"), id(e))
    gaps, cur = [], t0
    for e in ev:
        if e["ts"] > cur and cur < t1:
            gaps.append((cur, min(e["ts"], t1)))
        cur = max(cur, e["ts"] + e["dur"])
    if t1 > cur:
        gaps.append((cur, t1))
    out = []
    for s, g_end in gaps:
        i = bisect.bisect_left(starts, g_end)
        bound = False
        if i < len(every):
            ts = every[i]["ts"]
            while i < len(every) and every[i]["ts"] == ts:
                e = every[i]
                cid = e.get("args", {}).get("correlation")
                if first_of.get(cid) == id(e) and launch_end.get(cid, s) > s:
                    bound = True
                i += 1
        out.append((s, g_end, bound))
    return out


def charge(stretches, window_trace: dict) -> dict:
    """{span name: us}: each stretch split at the program spans' ends and
    every part charged to the innermost span open over it (the latest
    started of those that cover it), else to NO_SPAN."""
    spans = sorted(((e["ts"], e["ts"] + e["dur"], e["name"])
                    for e in btrace._complete(window_trace, (SPAN_CAT,))), key=lambda x: x[0])
    out = collections.Counter()
    for s, e, _ in stretches:
        around = [sp for sp in spans if sp[0] < e and sp[1] > s]
        cuts = sorted({s, e} | {x for sp in around for x in sp[:2] if s < x < e})
        for a, b in zip(cuts, cuts[1:]):
            mid = 0.5 * (a + b)
            inner = [sp for sp in around if sp[0] <= mid < sp[1]]
            out[max(inner, key=lambda sp: sp[0])[2] if inner else NO_SPAN] += b - a
    return dict(out)


def host_idle(window_trace: dict) -> dict:
    """{'host_idle_share' (% of the window, the tracing counter's kernel
    time left out as `benchmark/trace.py` leaves it), 'host_idle_us', 'queued_idle_us',
    'by_span_us' ({span: host-bound us})}, or {} without a window."""
    bounds = btrace.window_bounds(window_trace)
    if bounds is None or bounds[1] <= bounds[0]:
        return {}
    t0, t1 = bounds
    st = idle_stretches(window_trace, t0, t1)
    bound = [x for x in st if x[2]]
    host_us = sum(e - s for s, e, _ in bound)
    counting = btrace.busy_us([e for e in btrace._complete(window_trace, btrace.DEVICE_CATS)
                               if btrace.tracing_only(e)], t0, t1)
    return dict(host_idle_share=100.0 * host_us / (t1 - t0 - counting), host_idle_us=host_us,
                queued_idle_us=sum(e - s for s, e, b in st if not b),
                by_span_us=charge(bound, window_trace))


def waste_ratio(counters0: dict, counters1: dict, steps: int, units_per_step: float):
    """Listed pairs a step over useful pairs a step, or None where the
    program counted none."""
    if LISTED not in counters1 or not steps or not units_per_step:
        return None
    return (counters1[LISTED] - counters0.get(LISTED, 0)) / steps / units_per_step


def _outermost_rework(spans: list):
    """The REWORK spans that have ended and lie inside no other."""
    for s in spans:
        if s["name"] not in REWORK or s["end"] is None:
            continue
        p, nested = s["parent"], False
        while p >= 0 and not nested:
            nested = spans[p]["name"] in REWORK
            p = spans[p]["parent"]
        if not nested:
            yield s


def rework_s(spans: list, t_open: float):
    """Seconds of the outermost REWORK spans that ended by `t_open` (on
    `time.perf_counter`'s clock, as the spans), or None without spans."""
    if not spans:
        return None
    return sum(s["end"] - s["start"] for s in _outermost_rework(spans) if s["end"] <= t_open)


def rework_share(spans: list, t_open: float, t_close: float):
    """% of [t_open, t_close] spent in the outermost REWORK spans opened
    inside it (cut at t_close), or None without spans."""
    if not spans or t_close <= t_open:
        return None
    inside = sum(min(s["end"], t_close) - s["start"] for s in _outermost_rework(spans)
                 if t_open <= s["start"] < t_close)
    return 100.0 * inside / (t_close - t_open)


def summarise(window_trace: dict, snap: dict, counters0: dict, t_open: float, t_close: float,
              steps: int, units_per_step: float, chunk: int) -> dict:
    """What the readers take: `snap` is the port's `profiling.snapshot()`
    at the window's end, `counters0` its counters at the window's start,
    [t_open, t_close] the window on the spans' clock, and `chunk` the steps
    a chunk (the split is given in ms a chunk)."""
    idle = host_idle(window_trace)
    counters = snap["counters"]
    listed = None
    if LISTED in counters and steps:
        listed = (counters[LISTED] - counters0.get(LISTED, 0)) / steps
    per_chunk = 1e3 * steps / chunk
    return dict(host_idle_share=idle.get("host_idle_share"),
                queued_idle_us=idle.get("queued_idle_us"),
                host_idle_ms_per_chunk_by_span={k: v / per_chunk for k, v in
                                                idle.get("by_span_us", {}).items()},
                listed_pairs_per_step=listed,
                waste_ratio=waste_ratio(counters0, counters, steps, units_per_step),
                rework_s=rework_s(snap["spans"], t_open),
                rework_share=rework_share(snap["spans"], t_open, t_close),
                window_counts={k: counters.get(k, 0) - counters0.get(k, 0) for k in COUNTED})
