"""`benchmark/spans.py` on the CPU: the split of the idle time on a
hand-made Chrome trace, and the readers on the port's own spans and
counters from a tiny densifying cell run through `harness.run_cell` with
its trace on (the CPU has no device timeline: a stand-in profiler returns
a hand-made one)."""

from __future__ import annotations

import os
import time

import pytest
import torch

from benchmark import harness, program, spans, trace
from benchmark.tests.test_benchmark_harness import (BENCH, CHUNK, TINY_CONFIG, TINY_LIMITS,
                                                    TINY_TRAFFIC)


def X(cat, name, ts, dur, cid=None):
    e = dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, pid=1, tid=1)
    if cid is not None:
        e["args"] = {"correlation": cid}
    return e


# Spins bound the window at [20, 140] us. A graph launch (1) ending at 35
# runs k1 at 40 and k2 at 55: [20, 40] waited for it (host-bound), [50, 55]
# lies inside the graph (queued). A kernel launch (2) returned at 65 before
# the stretch [65, 80] that k3 ends (queued). A copy (3) launched until 120
# ends [90, 125] (host-bound), and the closing spin's launch (4) [130, 140].
HAND = {"traceEvents": [
    X("kernel", "spin_kernel", 0, 10), X("kernel", "spin_kernel", 10, 10),
    X("cuda_runtime", "cudaGraphLaunch", 15, 20, 1),
    X("kernel", "k1", 40, 10, 1), X("kernel", "k2", 55, 10, 1),
    X("cuda_runtime", "cudaLaunchKernel", 60, 5, 2), X("kernel", "k3", 80, 10, 2),
    X("cuda_runtime", "cudaMemcpyAsync", 100, 20, 3), X("gpu_memcpy", "Memcpy DtoH", 125, 5, 3),
    X("cuda_runtime", "cudaLaunchKernel", 130, 2, 4), X("kernel", "spin_kernel", 140, 10, 4),
    X("user_annotation", "fit.chunk", 12, 100), X("user_annotation", "chunk.launch", 14, 30),
    X("user_annotation", "fit.callback", 112, 25),
]}


def test_idle_split_on_a_hand_made_trace():
    stretches = spans.idle_stretches(HAND, 20, 140)
    assert stretches == [(20, 40, True), (50, 55, False), (65, 80, False), (90, 125, True),
                         (130, 140, True)]
    idle = spans.host_idle(HAND)
    assert idle["host_idle_us"] == 65 and idle["queued_idle_us"] == 20
    assert idle["host_idle_share"] == pytest.approx(100 * 65 / 120)
    assert idle["by_span_us"] == {"chunk.launch": 20, "fit.chunk": 22, "fit.callback": 20,
                                  spans.NO_SPAN: 3}
    busy = trace.busy_us(trace.device_events(HAND), 20, 140)
    assert idle["host_idle_us"] + idle["queued_idle_us"] == 120 - busy
    assert spans.host_idle({"traceEvents": []}) == {}


def test_rework_counts_outermost_spans_before_the_window():
    rec = [dict(name="fit.chunk", parent=-1, start=0.0, end=10.0),
           dict(name="gate.overflow_replay", parent=0, start=1.0, end=9.0),
           dict(name="gate.retune", parent=1, start=1.0, end=3.0),
           dict(name="chunk.capture", parent=1, start=3.0, end=8.0),
           dict(name="chunk.capture", parent=-1, start=11.0, end=12.5),
           dict(name="gate.retune", parent=-1, start=20.0, end=21.0)]
    assert spans.rework_s(rec, 15.0) == pytest.approx(8.0 + 1.5)
    assert spans.rework_s([], 15.0) is None
    assert spans.waste_ratio({}, {}, 10, 5.0) is None
    assert spans.waste_ratio({spans.LISTED: 100}, {spans.LISTED: 700}, 10, 4.0) == 15.0


# A device timeline for the CPU: spins at both ends, one kernel launched
# under `densify_step` that the device waited 5 us for.
DENSIFY_FRAME = "nlos_gaussian_renderer_tpu_torch/models/densify.py(150): densify_step"
TIMELINE = {"traceEvents": [
    X("kernel", "spin_kernel", 0, 10), X("kernel", "spin_kernel", 10, 10),
    X("python_function", DENSIFY_FRAME, 21, 5),
    X("cuda_runtime", "cudaLaunchKernel", 22, 3, 1), X("kernel", "k1", 30, 10, 1),
    X("kernel", "listed_pairs_kernel", 40, 4, 1), X("kernel", "spin_kernel", 50, 10),
]}


class TimelineProfiler:
    """`trace.Profiler`'s interface, returning TIMELINE."""

    def __init__(self, *a, **k):
        pass

    def start(self):
        pass

    def stop(self):
        return TIMELINE


def tiny_densify() -> dict:
    """The tiny cell (chunks of CHUNK steps) from the step counter 5,290
    with an event every CHUNK steps, 4 near-dead rows planted: the checked
    chunk ends with an event that relocates 4 rows and revives 8. Its
    untimed window is two chunks, whatever `--seconds` says."""
    optim = dict(harness.load_json(os.path.join(BENCH, "configs", "zaragoza256-rsort.json"))[
        "optimization"], densification_interval=CHUNK)
    return dict(entry=dict(name="tiny-densify", chips=1),
                config=dict(TINY_CONFIG, optimization=optim),
                traffic=dict(TINY_TRAFFIC, start_step=5290, window_steps=2 * CHUNK,
                             near_dead=dict(every=50, opacity=0.001)),
                cell=dict(limits=dict(TINY_LIMITS, donor_gap=0.01)))


NEW_READERS = ("device.host_idle_share", "cull.waste_ratio", "setup.rework_s",
               "gate.rework_share", "densify.device_ms")


def test_a_traced_densifying_run_reaches_every_reader(monkeypatch):
    """`tiny_densify`: the checked chunk ends with an event, and so does the
    traced one."""
    monkeypatch.setattr(program, "CHUNK", CHUNK)
    monkeypatch.setattr(trace, "Profiler", TimelineProfiler)
    man = harness.manifest()
    for m in man["per_layer"]:
        m["workloads"] = ["tiny-densify"]
    out = harness.run_cell(man, "tiny-densify", 135792468013, 0.2, True, time.perf_counter(),
                           device="cpu", spec=tiny_densify())
    rec, result = out["rec"], out["result"]
    assert result["correct"], result["checked"]
    assert result["checked"]["donor_gap"]["value"] < 1e-3
    prog = rec["program"]
    assert prog["window_counts"]["chunk.densify_replays"] == 1
    assert prog["window_counts"]["gate.retunes"] >= 0
    assert prog["listed_pairs_per_step"] > 0 and prog["waste_ratio"] >= 1
    assert prog["host_idle_share"] == pytest.approx(100 * 10 / 26)
    assert rec["densify"]["device_ms"] == pytest.approx(0.01)
    # the counter's kernel is left out of the device time and the window
    assert rec["traced"]["busy_s"] == pytest.approx(10e-6)
    assert rec["traced"]["window_s"] == pytest.approx(26e-6)
    for name in NEW_READERS:
        assert isinstance(result["metrics"][name]["value"], float), name
    assert result["metrics"]["gate.rework_share"]["value"] > 0
    # the window as the port recorded it: enough for a reader of its own
    raw = rec["raw"]
    assert raw["trace"] is TIMELINE and raw["steps"] == CHUNK
    assert raw["t_open"] < raw["t_close"] and raw["spans"]
    assert spans.rework_share(raw["spans"], raw["t_open"], raw["t_close"]) == (
        prog["rework_share"])
    assert (raw["counters_close"]["chunk.densify_replays"]
            - raw["counters_open"].get("chunk.densify_replays", 0)) == 1


@pytest.mark.parametrize("fault", ["fault_densify_key", "fault_densify_skipped"])
def test_a_densify_fault_is_not_correct(monkeypatch, fault):
    """The tiny densifying cell with its event's donors drawn under the
    next step counter, or its event skipped, in the timed path."""
    from benchmark import calibrate

    monkeypatch.setattr(program, "CHUNK", CHUNK)
    with calibrate.densify_fault(fault):
        out = harness.run_cell(harness.manifest(), "tiny-densify", 246813579024, 0.2, False,
                               time.perf_counter(), device="cpu", spec=tiny_densify())
    checked = out["result"]["checked"]
    assert not out["result"]["correct"], checked
    assert out["result"]["attempted"] == 2 * CHUNK
    if fault == "fault_densify_key":
        assert checked["donor_gap"]["value"] >= 0.5
    else:
        assert checked["change_gap"]["value"] > TINY_LIMITS["change_gap"]
