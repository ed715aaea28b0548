"""`benchmark/spans.py` on the CPU: the split of the idle time on a
hand-made Chrome trace, and the readers on the port's own spans and
counters from a tiny traced `fit` (the harness's tiny cell, with the
port's tracing switched on around it)."""

from __future__ import annotations

import os

import pytest
import torch

from benchmark import harness, inputs, program, spans, work
from benchmark.tests.test_benchmark_harness import BENCH, CHUNK, TINY_CONFIG, TINY_TRAFFIC
from nlos_gaussian_renderer_tpu_torch.utils import profiling


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
    from benchmark import trace as btrace

    stretches = spans.idle_stretches(HAND, 20, 140)
    assert stretches == [(20, 40, True), (50, 55, False), (65, 80, False), (90, 125, True),
                         (130, 140, True)]
    idle = spans.host_idle(HAND)
    assert idle["host_idle_us"] == 65 and idle["queued_idle_us"] == 20
    assert idle["host_idle_share"] == pytest.approx(100 * 65 / 120)
    assert idle["by_span_us"] == {"chunk.launch": 20, "fit.chunk": 22, "fit.callback": 20,
                                  spans.NO_SPAN: 3}
    busy = btrace.busy_us(btrace.device_events(HAND), 20, 140)
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


class TracedRun(program.Run):
    """The harness's run, reading the port's counters where the callback
    has synchronized at the window's ends, and its spans at the last."""

    c0 = state0 = snap = None

    def callback(self, it, state, aux):
        opened = self.t0 is not None
        try:
            super().callback(it, state, aux)
        finally:
            if not opened and self.t0 is not None:
                self.c0 = profiling.snapshot()["counters"]
                self.state0 = program.state_dict(state)
            if self.t1 is not None and self.snap is None:
                self.snap = profiling.snapshot()


def test_the_readers_on_a_tiny_traced_fit(monkeypatch):
    monkeypatch.setattr(program, "CHUNK", CHUNK)
    config = dict(TINY_CONFIG, optimization=harness.load_json(
        os.path.join(BENCH, "configs", "zaragoza256-rsort.json"))["optimization"])
    max_steps = TINY_TRAFFIC["warm_steps"] + 4 * CHUNK
    traffic = dict(TINY_TRAFFIC, max_steps=max_steps)
    dev = torch.device("cpu")
    inp = inputs.make_inputs(config, traffic, 987654321987, dev, chunk=config["reference_chunk"])
    run = TracedRun(config, inp, traffic["warm_steps"], 0.2, max_steps=max_steps)
    profiling.reset()
    profiling.enable_tracing(True)
    try:
        run.run()
    finally:
        profiling.enable_tracing(False)
    steps = run.steps1 - run.steps0
    cams, _ = inputs.step_inputs(inp, config, run.steps0, steps)
    sc = inputs.scene_constants(config)
    units = sum(work.useful_units("sampled", run.state0["params"], cam, sc)
                for cam in cams) / steps
    out = spans.summarise({"traceEvents": []}, run.snap, run.c0, run.t0, steps, units, CHUNK)
    assert out["listed_pairs_per_step"] > 0 and out["waste_ratio"] >= 1
    assert out["rework_s"] is not None and out["rework_s"] >= 0
    assert out["host_idle_share"] is None
    assert any(s["name"] == "fit.chunk" and s["end"] <= run.t0 for s in run.snap["spans"])
