"""The port's tracing (`utils/profiling`) on the CPU: the spans and
counters of `train.fit`, its gate and its chunk, and the device counter
`cull.listed_pairs`.

Size: the port's synthetic dataset (4x4 scan, 64 bins, 8 GT Gaussians,
ns 12, so two angular tiles), 64 Gaussians on `pallas_rsort` (the kernel
wrappers' plain versions), SH degree 1, B 1, chunks of 4. The densified
runs add MCMC densification every 4 steps (48 Gaussians, cap 256), and the
overflowing ones start from starved caps (w_max 2), so the gate re-tunes
and replays."""

import json

import numpy as np
import pytest
import torch

from nlos_gaussian_renderer_tpu_torch import train
from nlos_gaussian_renderer_tpu_torch.configs.default import Config, OptimizationParams
from nlos_gaussian_renderer_tpu_torch.data.synthetic import make_synthetic_dataset
from nlos_gaussian_renderer_tpu_torch.ops import fused_rsort as fr
from nlos_gaussian_renderer_tpu_torch.tools import kernel_work
from nlos_gaussian_renderer_tpu_torch.utils import profiling

torch.set_num_threads(1)

FIT_SPANS = {"fit.prepare", "fit.chunk", "gate.snapshot", "chunk.launch",
             "gate.overflow_read", "fit.log_read"}
# The spans each may sit under (fit.chunk's children as the gate and the
# chunk open them; None: at the top).
PARENTS = {
    "fit.prepare": {None}, "fit.chunk": {None}, "fit.log_read": {None},
    "fit.callback": {None}, "fit.densify": {None, "gate.overflow_replay"},
    "gate.snapshot": {"fit.chunk", None}, "chunk.launch": {"fit.chunk", None},
    "gate.overflow_read": {"fit.chunk", "gate.overflow_replay", None},
    "gate.overflow_replay": {"fit.chunk", None},
    "gate.retune": {"gate.overflow_replay", None},
    "chunk.capture": {"fit.chunk", "gate.overflow_replay"},
}


@pytest.fixture
def fresh():
    """Tracing off, nothing recorded and no device counter, before and
    after the test (the CPU counters are in no captured graph)."""
    def clear():
        profiling.enable_tracing(False)
        profiling.reset()
        profiling._device_counters.clear()

    clear()
    yield
    clear()


@pytest.fixture(scope="module")
def data():
    return make_synthetic_dataset(seed=0, scan_m=4, scan_n=4, num_bins=64,
                                  num_gt_gaussians=8, num_sampling_points=8, device="cpu")


def config(data, **kw):
    nz = np.nonzero(data.nlos_data.sum(axis=(1, 2)))[0]
    out = dict(renderer="pallas_rsort", start=int(nz[0]), end=int(nz[-1]) + 1,
               num_sampling_points=12, sh_degree=1, init_gaussian_num=64,
               space_carving_init=False, save_fig=False, gt_times=100.0, batch_size=1)
    out.update(kw)
    return Config(**out)


def densified_optim(**kw):
    out = dict(mcmc_densification_flag=True, densify_from_iter=1, densify_until_iter=1000,
               densification_interval=4, cap_max=256)
    out.update(kw)
    return OptimizationParams(**out)


def starve_initial_caps(monkeypatch):
    """`prepare_training`'s fit hands back w_max 2, so the first renders
    overflow and the gate re-tunes and replays."""
    orig = train.fit_culling_capacity

    def patched(settings, scene, probes, box, c, dt, grow_only=True, **kw):
        if not grow_only:
            return settings._replace(rsort_spec=settings.rsort_spec._replace(
                w_max=2, max_groups=8)), True
        return orig(settings, scene, probes, box, c, dt, grow_only=grow_only, **kw)

    monkeypatch.setattr(train, "fit_culling_capacity", patched)


def span_tree(spans):
    """{index: parent's name or None}, checking that each span lies inside
    its parent and closed."""
    out = {}
    for i, s in enumerate(spans):
        assert s["end"] is not None and s["end"] >= s["start"], s
        p = s["parent"]
        if p < 0:
            out[i] = None
            continue
        assert p < i, (i, p)
        par = spans[p]
        assert par["start"] <= s["start"] and s["end"] <= par["end"], (s, par)
        out[i] = par["name"]
    return out


def test_tracing_off_records_nothing(fresh, data, tmp_path):
    """Off (the default): no span, no counter and no counter tensor, and a
    profiled step holds no `user_annotation`."""
    from torch.profiler import ProfilerActivity, profile

    cfg = config(data)
    optim = OptimizationParams()
    scene, tx, settings, box = train.prepare_training(cfg, optim, data, device="cpu")
    state = train.create_train_state(scene, tx)
    step = train.make_train_step(settings, optim, cfg.sh_degree)
    cam = torch.as_tensor(np.ascontiguousarray(data.camera_grid_positions.T[:1]))
    nlos = data.nlos_data.reshape(data.nlos_data.shape[0], -1)
    tgt = torch.as_tensor(np.ascontiguousarray(nlos[cfg.start:cfg.end, :1].T)) * cfg.gt_times
    consts = (box, data.c, data.deltaT, torch.as_tensor(data.volume_position))
    assert profiling.span("fit.chunk") is profiling.span("gate.retune")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("fit.chunk"):
            aux = step(state, cam, tgt, *consts)
        profiling.count("gate.retunes")
    assert torch.isfinite(aux.loss)
    assert profiling.snapshot() == {"spans": [], "counters": {}}
    assert profiling._device_counters == {}
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    assert not any(e.get("cat") == "user_annotation" for e in events)


@pytest.mark.parametrize("per_step", [False, True], ids=["chunked", "per_step"])
def test_fit_span_tree(fresh, data, tmp_path, per_step):
    """A tiny fit with tracing on: the spans nest as documented, every
    `fit.chunk` has one `gate.overflow_read` of its own, and while a
    profiler records each span is a `user_annotation` of its name."""
    from torch.profiler import ProfilerActivity, profile

    kw = dict(num_iters=8, log_every=4, device="cpu")
    if per_step:
        kw["callback"] = lambda it, st, aux: None
    else:
        kw.update(callback=lambda it, st, aux: None, callback_every=4)
    profiling.enable_tracing(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = train.fit(config(data), OptimizationParams(), data, **kw)
    profiling.enable_tracing(False)
    spans = profiling.snapshot()["spans"]
    parents = span_tree(spans)
    names = [s["name"] for s in spans]
    assert FIT_SPANS - {"fit.chunk"} <= set(names) and "fit.callback" in names
    for i, name in enumerate(names):
        assert parents[i] in PARENTS[name], (name, parents[i])
    if per_step:
        assert "fit.chunk" not in names
        assert names.count("chunk.launch") == 8 and names.count("gate.overflow_read") == 2
        assert names.count("fit.callback") == 8
    else:
        assert res.chunk_stats["chunk"] == 4 and names.count("fit.chunk") == 2
        for i in (i for i, n in enumerate(names) if n == "fit.chunk"):
            kids = [names[j] for j, p in enumerate(s["parent"] for s in spans) if p == i]
            assert kids == ["gate.snapshot", "chunk.launch", "gate.overflow_read"], kids
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    marked = [e["name"] for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "user_annotation"]
    assert sorted(marked) == sorted(names)


@pytest.mark.parametrize("per_step", [False, True], ids=["chunked", "per_step"])
def test_host_counters_equal_fit_statistics(fresh, data, monkeypatch, per_step):
    """A densified run from starved caps (it overflows, re-tunes, replays
    and densifies): each host counter equals the statistic `fit` returns,
    and the gate's and the densify step's spans appear."""
    starve_initial_caps(monkeypatch)
    kw = dict(num_iters=12, log_every=4, device="cpu")
    optim = densified_optim()
    if per_step:
        kw["callback"] = lambda it, st, aux: None
    profiling.enable_tracing(True)
    res = train.fit(config(data, init_gaussian_num=48), optim, data, **kw)
    snap = profiling.snapshot()
    counters, names = snap["counters"], {s["name"] for s in snap["spans"]}
    assert res.retunes >= 1 and not res.overflow_detected
    assert counters["gate.retunes"] == res.retunes
    assert counters["gate.overflow_replays"] >= 1
    assert {"gate.retune", "gate.overflow_replay"} <= names
    if per_step:
        assert res.chunk_stats is None and "fit.densify" in names
    else:
        st = res.chunk_stats
        assert st["densify_replays"] >= 3
        for name in ("captures", "replays", "densify_replays", "layout_replays"):
            assert counters.get(f"chunk.{name}", 0) == st[name], name


def run_counted(data, monkeypatch):
    """A tiny chunked fit with tracing on: (its `cull.listed_pairs`, the
    sum of `kernel_work.rsort_field_work`'s pairs over the lists each of
    its steps' field evaluated, the number of those evaluations)."""
    seen = []
    real = fr.listed_pairs

    def spy(fwd, n_items, words, geo, total):
        seen.append(kernel_work.rsort_field_work(words, fwd, n_items, geo, 1, 1)["pairs"])
        real(fwd, n_items, words, geo, total)

    monkeypatch.setattr(fr, "listed_pairs", spy)
    profiling.reset()
    profiling.enable_tracing(True)
    train.fit(config(data), OptimizationParams(), data, num_iters=8, log_every=4,
              device="cpu")
    profiling.enable_tracing(False)
    return profiling.snapshot()["counters"]["cull.listed_pairs"], sum(seen), len(seen)


def test_listed_pairs_equal_kernel_work_and_repeat(fresh, data, monkeypatch):
    counted, work, calls = run_counted(data, monkeypatch)
    assert calls == 8  # one field a step; the capacity fits cull only
    assert counted == int(work) > 0
    assert run_counted(data, monkeypatch)[0] == counted


def test_listed_pairs_plain_counts_members_bins_and_rays():
    """The plain count on a hand-made list: two blocks of 4 rows, 2 x 2
    tiles; item 0 (tile 1, block 0, bins 2-4) has 2 member rows, item 1
    (tile 3, block 1, bins 0-0) 1; the third item lies past n_items."""
    geo = fr.RSortGeometry(n_tt=2, n_pt=2, n_ch=1, t_chunk=8, g_tile=4, s_ang=6)
    b_t, b_p, _ = fr._rect_bits(2, 2)

    def word(th_lo, th_hi, ph_lo, ph_hi):
        return (((((1 << b_t | th_lo) << b_t | th_hi) << b_p | ph_lo) << b_p) | ph_hi)

    words = torch.tensor([word(0, 0, 0, 1), word(0, 1, 1, 1), word(1, 1, 0, 0), 0,
                          word(1, 1, 1, 1), word(0, 0, 0, 0), 0, 0], dtype=torch.int32)
    fwd = torch.tensor([[1, 3, 0], [0, 0, 0], [0, 1, 1], [1, 1, 0], [2, 0, 0], [4, 0, 7]],
                       dtype=torch.int32)
    total = torch.zeros(1, dtype=torch.int64)
    fr.listed_pairs(fwd, torch.tensor([2], dtype=torch.int32), words, geo, total)
    assert int(total) == (2 * 3 + 1 * 1) * 6
    work = kernel_work.rsort_field_work(words, fwd, torch.tensor([2], dtype=torch.int32),
                                        geo, 1, 1)
    assert work["pairs"] == int(total)
