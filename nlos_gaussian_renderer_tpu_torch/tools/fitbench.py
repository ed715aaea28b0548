"""`fit`, the training entry point, on the card: chunks replayed from a CUDA
graph against the per-step path.

    python -m nlos_gaussian_renderer_tpu_torch.tools.fitbench

The data are the committed Zaragoza artifact
(`examples/data/zaragoza64_bunny.mat`: 64x64 scan points, 256 bins of
c*dt 7.8 mm), trained in a 200-bin window over its signal (`window`), from
`Config(rng=0)`'s uniform init: `pallas_rsort`, 32x32 angles, B = 1, SH
degree 3. `run` measures, in this order:

  1. `fit` on the chunked path (ITERS iterations in chunks of 50, each a
     CUDA graph of one step replayed 50 times), ms per chunk from callback
     timestamps (every chunk ends in a host read of its overflow flag), the
     captures, the wrapper calls recorded into a graph a replay, and the
     launch counters over the run (wrapper calls outside a capture: a
     replay makes none);
  2. `fit` on the per-step path (a callback without a cadence) on the same
     data and seed;
  3. from one snapshot of the initial state: one chunk from its graph and
     the same steps eagerly, twice: every parameter and both Adam moments
     compared (replay vs eager, eager vs eager); then the chunk and the
     eager steps timed between CUDA events, and each under
     `torch.profiler` (device ms a step, device events by kernel; the
     eager run's wrapper calls beside them, so the graph's events can be
     held to its recorded calls);
  4. the overflow replay: `fit` at 5k Gaussians with the initial rsort caps
     starved (w_max 4, max_groups 8) against the same run with fitted caps;
  5. `pallas_analytic` and `pallas` through the chunked `fit` (OTHER_ITERS
     iterations); `pallas`'s chunk from its graph against the same steps
     eagerly, twice (bit for bit, as `pallas_rsort`'s).

`run_densified` measures the reference's real training regime, MCMC
densification with SGLD noise (`DENSIFY`), from 50,000 of 100,000 slots
(`Config(rng=0)`'s uniform init), events at post-update counters 100, ...,
300, each at index 48 of its chunk of 50:

  6. `fit` on the chunked path (each chunk one step's graph replayed 50
     times, the densify graph after replay 48) and on the per-step path,
     compared: `alive`, losses, means; the population, re-tunes and the
     caps after each, every capture's seconds;
  7. from one fresh state, one chunk of 50 holding two densify events
     (every 25 from 10) from its graphs against the same steps and events
     eagerly, twice; the densify graph's device ms (CUDA events, profiler);
     the cost of `train.clone_state` (a callback's copy) at 100k;
  8. the overflow replay through two densify events at 5k (cap 10,000):
     starved caps against fitted caps;
  9. `pallas_analytic` densified through the chunked `fit` (OTHER_ITERS).

`run_frozen` measures `Config(frozen_layout=True)` (each chunk renders
through one block layout built at its entry from `train.layout_reference`):

 10. `fit` on the chunked path (ITERS, chunks of 50: per chunk one replay
     of the layout's graph, then 50 of the step's) with its re-tunes, caps
     and peak device memory;
 11. one chunk from its graphs against the same steps eagerly through one
     layout built eagerly, twice (as 3), timed and profiled, beside the
     same for the chunk without a layout, in the same process; each graph
     replayed alone under the profiler, its sort kernels counted
     (`sort_events`): the step's graph with a layout launches none;
 12. a densified frozen-layout `fit` (DENSIFY, OTHER_ITERS): `fit` takes
     the per-step path, whose steps use no layout.

The card only (CUDA graphs); it prints one JSON line, the numbers
`chip_smoke.py` gates and records. `--frozen` runs `run_frozen` alone.
`--pallas-step` measures `pallas`'s chunk alone (`pallas_step`): run as a
file with another tree first on PYTHONPATH, it compares two trees' steps,

    PYTHONPATH=<tree> python nlos_gaussian_renderer_tpu_torch/tools/fitbench.py --pallas-step
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import numpy as np
import torch

from nlos_gaussian_renderer_tpu_torch import train
from nlos_gaussian_renderer_tpu_torch.configs.default import Config, OptimizationParams
from nlos_gaussian_renderer_tpu_torch.data.zaragoza import NLOSData, load_zaragoza256_data
from nlos_gaussian_renderer_tpu_torch.models.densify import densify_step
from nlos_gaussian_renderer_tpu_torch.ops import cuda_build
from nlos_gaussian_renderer_tpu_torch.tools import resolve_device

ARTIFACT = os.path.join(os.path.dirname(__file__), "..", "..", "examples", "data",
                        "zaragoza64_bunny.mat")
WINDOW_BINS = 200
GAUSSIANS = 100_000
HEAL_GAUSSIANS = 5_000
ITERS = 300  # pallas_rsort's chunked and per-step fits
OTHER_ITERS = 100  # pallas_analytic's and pallas's chunked fits
RSORT_KERNELS = ("cull_reduce", "build_work_lists", "rsort_fwd", "rsort_bwd")
# The densified regime: MCMC densification every 50 iterations from 50
# (events at post-update counters 100, ..., 300) with SGLD noise, growing
# from DENSIFY_GAUSSIANS toward cap_max (the default 100,000).
DENSIFY = dict(mcmc_densification_flag=True, densify_from_iter=50,
               densification_interval=50, sgld_noise=True)
DENSIFY_GAUSSIANS = 50_000


def window(data: NLOSData, bins: int = WINDOW_BINS, margin: int = 8):
    """[start, start + bins) inside the data's bins, starting `margin` bins
    before its first nonzero bin where there is room."""
    total = data.nlos_data.shape[0]
    first = int(np.nonzero(data.nlos_data.reshape(total, -1).sum(axis=1))[0][0])
    start = min(max(first - margin, 0), total - bins)
    return start, start + bins


def config(data: NLOSData, renderer="pallas_rsort", gaussians=GAUSSIANS, **kw) -> Config:
    start, end = window(data)
    return Config(renderer=renderer, init_gaussian_num=gaussians, num_sampling_points=32,
                  batch_size=1, space_carving_init=False, start=start, end=end, **kw)


def timed_fit(cfg, optim, data, iters, dev, per_step=False, log_every=None):
    """`fit` with the launch counters reset before it; the chunked path
    (callback_every 50) or the per-step path (a callback without one).
    Returns (FitResult, seconds, host seconds between callbacks, counts)."""
    stamps = []
    kw = dict(num_iters=iters, device=dev, log_every=log_every,
              callback=lambda it, st, aux: stamps.append(time.perf_counter()))
    if not per_step:
        kw["callback_every"] = 50
    cuda_build.reset_launch_counts()
    t0 = time.perf_counter()
    res = train.fit(cfg, optim, data, **kw)
    torch.cuda.synchronize(dev)
    return res, time.perf_counter() - t0, np.diff([t0] + stamps), cuda_build.launch_counts()


def _batches(cfg, data, k, dev):
    """(k, B, 3) cameras and (k, B, num_r) targets of `fit`'s first k steps."""
    l, m, n = data.shape
    stream = train.scan_point_stream(np.random.default_rng(cfg.rng), m, n, cfg.batch_size)
    idx = np.stack([next(stream) for _ in range(k)])
    cams = data.camera_grid_positions.T[idx]
    tgt = (data.nlos_data.reshape(l, m * n)[cfg.start:cfg.end].T * np.float32(cfg.gt_times))
    return (torch.as_tensor(np.ascontiguousarray(cams), device=dev),
            torch.as_tensor(np.ascontiguousarray(tgt[idx]), device=dev))


def _max_abs(a, b) -> list:
    return [float((x.detach().double() - y.detach().double()).abs().max()) if x.numel()
            else 0.0 for x, y in zip(a, b)]


def _diffs(a, b):
    """Largest |a - b| over the state's tensors, and whether all are equal."""
    return max(_max_abs(a, b)), all(torch.equal(x, y) for x, y in zip(a, b))


# The names of `train.state_tensors`' entries, in order.
STATE_NAMES = (list(train.GROUPS) + ["alive"] + [f"mu/{g}" for g in train.GROUPS]
               + [f"nu/{g}" for g in train.GROUPS] + ["count", "step", "active_sh_degree"])


def replay_vs_eager(cfg, optim, data, dev, k=50, timing=True):
    """One chunk from its graph and k eager steps (twice) from one snapshot,
    the densify events (`fit`'s) after the same steps in both; then, with
    `timing`, the same chunk and steps timed, and one chunk profiled."""
    scene, tx, settings, box = train.prepare_training(cfg, optim, data, device=dev)
    state = train.create_train_state(scene, tx)
    consts = (box, data.c, data.deltaT, torch.as_tensor(data.volume_position, device=dev))
    cams, tgts = _batches(cfg, data, k, dev)
    ref_cam, slack = train.layout_reference(data) if cfg.frozen_layout else (None, 0.0)
    chunk = train.make_scanned_train_step(settings, optim, cfg.sh_degree, seed=cfg.rng,
                                          densify_seed=cfg.rng + 1, ref_cam=ref_cam,
                                          layout_slack=slack)
    step = train.make_train_step(settings, optim, cfg.sh_degree, seed=cfg.rng)
    s0 = train.snapshot_state(state)
    step0 = 1  # a fresh state's counter
    events = [i for i in range(k) if train.densify_fires(optim, step0 + i + 1)]

    def eager():
        # The chunk's layout (None without ref_cam), built eagerly from the
        # entering state, then the steps through it.
        layout = chunk.layout(state, *consts[:3])
        auxs = []
        for i in range(k):
            auxs.append(step(state, cams[i], tgts[i], *consts, layout=layout))
            if i in events:
                densify_step(state.scene, state.opt_state, cfg.rng + 1, state.step,
                             optim.cap_max)
        return train.stack_aux(auxs)

    out = dict(densify_events=events, alive_before=int(state.scene.num_alive))
    aux_r = chunk(state, cams, tgts, *consts, step0=step0)
    out["alive_after"] = int(state.scene.num_alive)
    out["densify_replays"] = chunk.densify_replays
    replayed = train.snapshot_state(state)
    train.restore_state(state, s0)
    aux_e = eager()
    eager1 = train.snapshot_state(state)
    train.restore_state(state, s0)
    eager()
    eager2 = train.snapshot_state(state)
    out["replay_vs_eager_max_abs"], out["replay_equals_eager"] = _diffs(replayed, eager1)
    out["replay_vs_eager_by_tensor"] = dict(zip(STATE_NAMES, _max_abs(replayed, eager1)))
    out["eager_vs_eager_max_abs"], out["eager_equals_eager"] = _diffs(eager1, eager2)
    out["losses_equal"] = bool(torch.equal(aux_r.loss, aux_e.loss))
    out["overflow"] = bool(aux_r.overflow) or bool(aux_e.overflow)
    out["caps"] = {k: getattr(settings.rsort_spec, k)
                   for k in ("w_max", "max_groups", "d_max", "dup_rows")}
    out["capture_s"], out["instantiate_s"] = chunk.capture_s, chunk.instantiate_s
    out["capture_log"] = list(chunk.capture_log)
    out["launches_per_replay"] = dict(chunk.launches_per_replay)
    # The same chunk once more from the snapshot (the overflow gate's
    # replay): the layout is rebuilt from the restored state.
    train.restore_state(state, s0)
    aux_2 = chunk(state, cams, tgts, *consts, step0=step0)
    _, equal_again = _diffs(train.snapshot_state(state), replayed)
    out["replay_again_equals"] = equal_again and bool(torch.equal(aux_2.loss, aux_r.loss))
    out["layout_replays"] = chunk.layout_replays
    if not timing:
        return out

    def timed(run, reps=2):
        ms = []
        for _ in range(reps):
            train.restore_state(state, s0)
            torch.cuda.synchronize(dev)
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            run()
            e1.record()
            torch.cuda.synchronize(dev)
            ms.append(e0.elapsed_time(e1) / k)
        return ms

    out["graph_ms_per_step"] = timed(lambda: chunk(state, cams, tgts, *consts, step0=step0))
    out["eager_ms_per_step"] = timed(eager)
    train.restore_state(state, s0)
    out["profile"] = profile_chunk(lambda: chunk(state, cams, tgts, *consts, step0=step0), k)
    train.restore_state(state, s0)
    cuda_build.reset_launch_counts()
    out["eager_profile"] = profile_chunk(eager, k)
    out["eager_launches"] = cuda_build.launch_counts()
    train.restore_state(state, s0)
    out["graphs"] = graph_events(chunk)
    out["peak_mib"] = torch.cuda.max_memory_allocated(dev) / 2**20
    return out


def is_sort_kernel(name: str) -> bool:
    """A device event of a sort (torch.sort's radix-sort kernels, any
    kernel named for a sort); `searchsorted` is a search and K3/K4
    (`rsort_*`) are the field kernels, not sorts."""
    return "sort" in name.lower().replace("searchsorted", "").replace("rsort_", "")


def graph_events(chunk) -> dict:
    """Each of the chunk's graphs replayed once alone under the profiler
    (the step's with its counter at 0): device events, sort events and
    their names. The caller restores the state after (a replayed step
    updates it)."""
    out = {}
    for name, graph in (("layout", chunk._lgraph), ("step", chunk._graph),
                        ("densify", chunk._dgraph)):
        if graph is None:
            continue
        chunk._i.zero_()
        prof = profile_chunk(graph.replay, 1)
        sorts = {n: c for n, (c, _) in prof["by_name"].items() if is_sort_kernel(n)}
        out[name] = dict(events=prof["events_per_step"], device_ms=prof["device_ms_per_step"],
                         sort_events=sum(sorts.values()),
                         sort_kernels=[n[:80] for n in sorts])
    chunk._i.zero_()
    return out


def profile_chunk(run, k):
    """`run` (one replayed chunk, or its steps eagerly) under torch.profiler:
    device ms a step (kernels, copies and fills, each event's own time),
    device events a step, and each kernel's device events (in all and a
    step) and ms a step by name. A spin kernel runs first in the window and
    is left out of every count: the profiler has dropped a window's first
    device event on the H100."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        run()
        torch.cuda.synchronize()
    by_name, n_events = {}, 0
    for e in prof.events():
        if (e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False)
                or e.name.startswith(("Optimizer.", "ProfilerStep"))
                or "spin_kernel" in e.name):
            continue
        cnt, ms = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (cnt + 1, ms + e.device_time_total / 1e3)
        n_events += 1
    per_kernel = {}
    for name in cuda_build.KERNELS:
        hits = [(c, ms) for n, (c, ms) in by_name.items() if f"{name}_" in n]
        per_kernel[name] = dict(events=sum(c for c, _ in hits),
                                events_per_step=sum(c for c, _ in hits) / k,
                                ms_per_step=sum(ms for _, ms in hits) / k)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    return dict(device_ms_per_step=sum(ms for _, ms in by_name.values()) / k,
                events_per_step=n_events / k, kernels=per_kernel,
                top=[(n[:80], c / k, ms / k) for n, (c, ms) in top],
                sort_events_per_step=sum(c for n, (c, _) in by_name.items()
                                         if is_sort_kernel(n)) / k,
                by_name=by_name)


@contextlib.contextmanager
def starved_initial_caps():
    """`prepare_training`'s initial fit hands back w_max 4 and max_groups 8
    (JAX's tests/test_train.py:415-433), so the first chunk overflows."""
    orig = train.fit_culling_capacity

    def patched(settings, scene, probes, box, c, dt, grow_only=True, **kw):
        if not grow_only:
            tiny = settings.rsort_spec._replace(w_max=4, max_groups=8)
            return settings._replace(rsort_spec=tiny), True
        return orig(settings, scene, probes, box, c, dt, grow_only=grow_only, **kw)

    train.fit_culling_capacity = patched
    try:
        yield
    finally:
        train.fit_culling_capacity = orig


def overflow_heal(data, optim, dev, iters=100):
    """5k Gaussians: fitted caps against starved ones, chunks of 50."""
    cfg = config(data, gaussians=HEAL_GAUSSIANS)
    ref = train.fit(cfg, optim, data, num_iters=iters, log_every=50, device=dev)
    with starved_initial_caps():
        res = train.fit(cfg, optim, data, num_iters=iters, log_every=50, device=dev)
    diff, equal = _diffs(train.state_tensors(res.state), train.state_tensors(ref.state))
    return dict(retunes=res.retunes, overflow_detected=res.overflow_detected,
                ref_retunes=ref.retunes, max_abs=diff, equal=equal,
                losses_equal=bool(np.array_equal(res.losses, ref.losses)),
                captures=res.chunk_stats["captures"],
                densify_replays=res.chunk_stats["densify_replays"],
                alive=int(res.state.scene.num_alive), ref_alive=int(ref.state.scene.num_alive))


def _fit_summary(res, seconds, chunk_s, counts, iters):
    return dict(losses=res.losses.tolist(), equal_losses=res.equal_losses.tolist(),
                ms_per_step=1e3 * seconds / iters, fit_ms_per_step=1e3 / res.iters_per_sec,
                chunk_ms_per_step=[float(1e3 * s / 50) for s in chunk_s],
                overflow_detected=res.overflow_detected, retunes=res.retunes,
                retune_caps=res.retune_caps, alive=int(res.state.scene.num_alive),
                chunk_stats=res.chunk_stats, launch_counts=counts,
                finite=bool(np.isfinite(res.losses).all()
                            and torch.isfinite(res.state.scene.means).all()))


def run(device="cuda") -> dict:
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("fitbench captures CUDA graphs: it runs on the card only")
    data = load_zaragoza256_data(os.path.normpath(ARTIFACT))
    optim = OptimizationParams()
    cfg = config(data)
    out = dict(window=list(window(data)), data_shape=list(data.shape), iters=ITERS,
               device=f"{torch.cuda.get_device_name(dev)} x{torch.cuda.device_count()}")
    res, sec, chunk_s, counts = timed_fit(cfg, optim, data, ITERS, dev)
    out["chunked"] = _fit_summary(res, sec, chunk_s, counts, ITERS)
    res, sec, _, counts = timed_fit(cfg, optim, data, ITERS, dev, per_step=True)
    out["per_step"] = _fit_summary(res, sec, [], counts, ITERS)
    out["replay"] = replay_vs_eager(cfg, optim, data, dev)
    out["heal"] = overflow_heal(data, optim, dev)
    for backend in ("pallas_analytic", "pallas"):
        res, sec, chunk_s, counts = timed_fit(config(data, renderer=backend), optim, data,
                                              OTHER_ITERS, dev)
        out[backend] = _fit_summary(res, sec, chunk_s, counts, OTHER_ITERS)
    out["pallas_replay"] = replay_vs_eager(config(data, renderer="pallas"), optim, data, dev,
                                           timing=False)
    return out


def _time_ms(run, dev, reps):
    """Mean ms of `run()` over `reps` calls between CUDA events."""
    torch.cuda.synchronize(dev)
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        run()
    e1.record()
    torch.cuda.synchronize(dev)
    return e0.elapsed_time(e1) / reps


def densify_costs(cfg, optim, data, dev, reps=10):
    """At the densified scene's capacity: one densify event's device ms
    from its graph (CUDA events over `reps` replays, and the profiler over
    one), eagerly, and `clone_state`'s ms (a callback's copy)."""
    scene, tx, settings, box = train.prepare_training(cfg, optim, data, device=dev)
    state = train.create_train_state(scene, tx)
    consts = (box, data.c, data.deltaT, torch.as_tensor(data.volume_position, device=dev))
    cams, tgts = _batches(cfg, data, 2, dev)
    chunk = train.make_scanned_train_step(settings, optim, cfg.sh_degree, seed=cfg.rng,
                                          densify_seed=cfg.rng + 1)
    # A chunk of 2 whose second step densifies (counter 2 moved to 99).
    state.step.fill_(98)
    chunk(state, cams, tgts, *consts, step0=98)
    s0 = train.snapshot_state(state)
    out = dict(capacity=state.scene.capacity, densify_replays=chunk.densify_replays)
    out["graph_ms"] = _time_ms(chunk._dgraph.replay, dev, reps)
    train.restore_state(state, s0)
    out["profile"] = profile_chunk(chunk._dgraph.replay, 1)
    train.restore_state(state, s0)
    out["eager_ms"] = _time_ms(
        lambda: densify_step(state.scene, state.opt_state, cfg.rng + 1, state.step,
                             optim.cap_max), dev, reps)
    out["clone_ms"] = _time_ms(lambda: train.clone_state(state), dev, reps)
    out["state_mb"] = sum(t.numel() * t.element_size()
                          for t in train.state_tensors(state)) / 2**20
    return out


def run_densified(device="cuda") -> dict:
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("fitbench captures CUDA graphs: it runs on the card only")
    data = load_zaragoza256_data(os.path.normpath(ARTIFACT))
    optim = OptimizationParams(**DENSIFY)
    cfg = config(data, gaussians=DENSIFY_GAUSSIANS)
    out = dict(iters=ITERS, gaussians=DENSIFY_GAUSSIANS, cap_max=optim.cap_max,
               events=[it + 2 for it in range(ITERS) if train.densify_fires(optim, it + 2)])
    res, sec, chunk_s, counts = timed_fit(cfg, optim, data, ITERS, dev, log_every=50)
    out["chunked"] = _fit_summary(res, sec, chunk_s, counts, ITERS)
    ps, sec, _, counts = timed_fit(cfg, optim, data, ITERS, dev, per_step=True, log_every=50)
    out["per_step"] = _fit_summary(ps, sec, [], counts, ITERS)
    a, b = res.state, ps.state
    means_diff = (a.scene.means - b.scene.means).detach().abs()
    out["paths"] = dict(
        alive_equal=bool(torch.equal(a.scene.alive, b.scene.alive)),
        means_max_abs=float(means_diff.max()),
        means_within=bool(torch.allclose(a.scene.means, b.scene.means, rtol=1e-4, atol=1e-6)),
        losses_within=bool(np.allclose(res.losses, ps.losses, rtol=1e-5, atol=0)),
        losses_max_rel=float(np.max(np.abs(res.losses - ps.losses) / np.abs(ps.losses))),
        state_max_abs=_diffs(train.state_tensors(a), train.state_tensors(b))[0],
        state_equal=_diffs(train.state_tensors(a), train.state_tensors(b))[1])
    del res, ps, a, b
    # One chunk of 50 holding two densify events (post-update counters 25, 50).
    every25 = optim.replace(densify_from_iter=10, densification_interval=25)
    out["replay"] = replay_vs_eager(cfg, every25, data, dev)
    out["costs"] = densify_costs(cfg, optim, data, dev)
    # The overflow replay through two densify events (counters 40, 80) at 5k.
    heal_optim = optim.replace(cap_max=2 * HEAL_GAUSSIANS, densify_from_iter=20,
                               densification_interval=40)
    out["heal"] = overflow_heal(data, heal_optim, dev)
    res, sec, chunk_s, counts = timed_fit(
        config(data, renderer="pallas_analytic", gaussians=DENSIFY_GAUSSIANS), optim, data,
        OTHER_ITERS, dev)
    out["pallas_analytic"] = _fit_summary(res, sec, chunk_s, counts, OTHER_ITERS)
    return out


def run_frozen(device="cuda") -> dict:
    """`fit` and its chunk with `frozen_layout=True` on the artifact at 100k
    (`pallas_rsort`), beside the chunk without a layout (10-12 above)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("fitbench captures CUDA graphs: it runs on the card only")
    data = load_zaragoza256_data(os.path.normpath(ARTIFACT))
    optim = OptimizationParams()
    cfg = config(data, frozen_layout=True)
    ref_cam, slack = train.layout_reference(data)
    out = dict(iters=ITERS, ref_cam=ref_cam.tolist(), slack=slack)
    torch.cuda.reset_peak_memory_stats(dev)
    res, sec, chunk_s, counts = timed_fit(cfg, optim, data, ITERS, dev)
    out["chunked"] = _fit_summary(res, sec, chunk_s, counts, ITERS)
    out["chunked"]["peak_mib"] = torch.cuda.max_memory_allocated(dev) / 2**20
    del res
    for name, c in (("replay", cfg), ("unlayouted", config(data))):
        torch.cuda.reset_peak_memory_stats(dev)
        out[name] = replay_vs_eager(c, optim, data, dev)
    dens = OptimizationParams(**DENSIFY)
    res, sec, _, counts = timed_fit(config(data, gaussians=DENSIFY_GAUSSIANS,
                                           frozen_layout=True), dens, data, OTHER_ITERS, dev,
                                    log_every=50)
    out["densified"] = _fit_summary(res, sec, [], counts, OTHER_ITERS)
    return out


def pallas_step(device="cuda") -> dict:
    """`pallas`'s chunk of 50 on the artifact at 100k: replay vs eager (and
    eager vs eager), each timed between CUDA events and under the profiler
    (device ms a step). Run as a file with another tree's package first on
    PYTHONPATH, it times that tree's step with this function."""
    dev = resolve_device(device)
    data = load_zaragoza256_data(os.path.normpath(ARTIFACT))
    out = replay_vs_eager(config(data, renderer="pallas"), OptimizationParams(), data, dev)
    out["package"] = os.path.dirname(os.path.dirname(os.path.abspath(train.__file__)))
    return out


def main():
    import sys

    torch.backends.cuda.matmul.allow_tf32 = False
    if "--pallas-step" in sys.argv[1:]:
        out = pallas_step()
    elif "--frozen" in sys.argv[1:]:
        out = run_frozen()
    else:
        out = run()
        out["densified"] = run_densified()
    print(json.dumps(out, default=str))
    return out


if __name__ == "__main__":
    main()
