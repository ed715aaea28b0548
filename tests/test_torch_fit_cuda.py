"""The chunk of `fit` on the card: one train step captured into a CUDA
graph and replayed K times (`train.ScannedTrainStep`).

Marked `cuda`: each test skips (from its fixture) where no GPU is present.
On the card: `python -m pytest tests/test_torch_fit_cuda.py -m cuda
--noconftest`. The scene is `prepare_training`'s on the committed Zaragoza
artifact at 5k Gaussians (`pallas_rsort`, 32x32 angles, 200 bins, B 1):
a chunk of 8 replayed from its graph equals 8 eager steps from the same
snapshot bit for bit (or within the spread of two eager runs), the replays
make no blocking host read, a re-tune captures a new graph that launches
K1-K4 at the new caps, and the launch counters count wrapper calls only
(a replay makes none) while the profiler sees each kernel's device events
in every replay. A densified chunk (MCMC densification every 3 steps and
SGLD noise, 5k of 6k slots) captures its densify step as a second graph
under the sync check, and its replay equals the same steps and events
eagerly bit for bit. With the port's tracing on, the replays count the
listed pairs (`cull.listed_pairs`) the eager steps count, at one more
launch a replay."""

import numpy as np
import pytest
import torch

from nlos_gaussian_renderer_tpu_torch import train
from nlos_gaussian_renderer_tpu_torch.configs.default import OptimizationParams
from nlos_gaussian_renderer_tpu_torch.data.zaragoza import load_zaragoza256_data
from nlos_gaussian_renderer_tpu_torch.models.densify import densify_step
from nlos_gaussian_renderer_tpu_torch.ops import cuda_build
from nlos_gaussian_renderer_tpu_torch.tools import fitbench

pytestmark = pytest.mark.cuda
K = 8
STEP_KERNELS = fitbench.RSORT_KERNELS + fitbench.CULL_KERNELS  # K1-K4, rows, L1-L3


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs and kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def setup(dev, gaussians=5_000, optim=None):
    data = load_zaragoza256_data(fitbench.ARTIFACT)
    cfg = fitbench.config(data, gaussians=gaussians)
    optim = optim or OptimizationParams()
    scene, tx, settings, box = train.prepare_training(cfg, optim, data, device=dev)
    state = train.create_train_state(scene, tx)
    consts = (box, data.c, data.deltaT, torch.as_tensor(data.volume_position, device=dev))
    cams, tgts = fitbench._batches(cfg, data, K, dev)
    return data, cfg, optim, settings, state, consts, cams, tgts


def test_chunk_replay_equals_eager_steps(dev):
    _, cfg, optim, settings, state, consts, cams, tgts = setup(dev)
    chunk = train.make_scanned_train_step(settings, optim, cfg.sh_degree)
    step = train.make_train_step(settings, optim, cfg.sh_degree)
    s0 = train.snapshot_state(state)
    aux = chunk(state, cams, tgts, *consts)
    replayed = train.snapshot_state(state)
    runs = []
    for _ in range(2):
        train.restore_state(state, s0)
        losses = [step(state, cams[i], tgts[i], *consts).loss for i in range(K)]
        runs.append((torch.stack(losses), train.snapshot_state(state)))
    spread, _ = fitbench._diffs(runs[0][1], runs[1][1])
    gap, equal = fitbench._diffs(replayed, runs[0][1])
    print(f"replay vs eager max |diff| {gap:.3e}, eager vs eager {spread:.3e}")
    assert not bool(aux.overflow) and chunk.captures == 1
    assert equal or gap <= spread, (gap, spread)
    assert torch.equal(aux.loss, runs[0][0]) or gap <= spread
    assert int(state.step) == 1 + K


def test_replays_make_no_blocking_host_read(dev):
    _, cfg, optim, settings, state, consts, cams, tgts = setup(dev)
    chunk = train.make_scanned_train_step(settings, optim, cfg.sh_degree)
    chunk(state, cams, tgts, *consts)  # captures
    torch.cuda.set_sync_debug_mode("error")
    try:
        aux = chunk(state, cams, tgts, *consts)
        with pytest.raises(RuntimeError):
            float(aux.loss[0])  # a blocking read does raise here
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert chunk.captures == 1 and chunk.replays == 2 * K
    assert torch.isfinite(aux.loss).all()


def test_retune_captures_a_new_graph_at_the_new_caps(dev):
    _, cfg, optim, settings, state, consts, cams, tgts = setup(dev)
    starved = settings._replace(rsort_spec=settings.rsort_spec._replace(w_max=4,
                                                                        max_groups=8))
    probes = np.zeros((1, 3), np.float32)
    gate = train.OverflowGate(starved, optim, cfg.sh_degree, probes, *consts[:3])
    first = gate.enable_chunk()
    aux = gate.run_gated(True, state, cams, tgts, *consts, what="the test chunk")
    # The gate's chunks count into its log: one capture by the first chunk
    # and one by each chunk a re-tune built.
    assert gate.chunk is not first and first.captures == gate.chunk.captures
    assert first.captures == len(gate.log.captures) == 1 + gate.retunes
    assert gate.retunes >= 1 and not gate.overflow_detected and not bool(aux.overflow)
    assert gate.settings.rsort_spec.w_max > 4
    assert gate.chunk.settings == gate.settings
    assert all(gate.chunk.launches_per_replay[k] == 1 for k in STEP_KERNELS)


def test_launch_counts_count_calls_and_the_profiler_sees_each_replay(dev):
    _, cfg, optim, settings, state, consts, cams, tgts = setup(dev)
    chunk = train.make_scanned_train_step(settings, optim, cfg.sh_degree)
    step = train.make_train_step(settings, optim, cfg.sh_degree)
    s0 = train.snapshot_state(state)
    cuda_build.reset_launch_counts()
    captured = cuda_build.captured_counts()
    chunk(state, cams, tgts, *consts)
    assert chunk.launches_per_replay == {k: 1 for k in STEP_KERNELS}
    after = cuda_build.captured_counts()
    assert all(after[k] - captured[k] == 1 for k in STEP_KERNELS)
    counts = cuda_build.launch_counts()
    assert all(counts[k] == 1 for k in STEP_KERNELS)  # the warm-up step; replays make no call
    train.restore_state(state, s0)
    graph = fitbench.profile_chunk(lambda: chunk(state, cams, tgts, *consts), K)
    train.restore_state(state, s0)
    cuda_build.reset_launch_counts()
    eager = fitbench.profile_chunk(
        lambda: [step(state, cams[i], tgts[i], *consts) for i in range(K)], K)
    calls = cuda_build.launch_counts()
    for k in STEP_KERNELS:
        ev = eager["kernels"][k]["events"]
        assert calls[k] == K and ev % K == 0 and ev >= K, (k, calls[k], ev)
        assert graph["kernels"][k]["events"] == ev // K * chunk.launches_per_replay[k] * K, k
    assert chunk.captures == 1


def test_densified_chunk_replay_equals_eager_bit_for_bit(dev):
    optim = OptimizationParams(mcmc_densification_flag=True, densify_from_iter=2,
                               densification_interval=3, cap_max=6_000, sgld_noise=True)
    _, cfg, optim, settings, state, consts, cams, tgts = setup(dev, optim=optim)
    chunk = train.make_scanned_train_step(settings, optim, cfg.sh_degree, seed=0,
                                          densify_seed=1)
    step = train.make_train_step(settings, optim, cfg.sh_degree, seed=0)
    events = [i for i in range(K) if train.densify_fires(optim, 2 + i)]
    assert events == [1, 4, 7]  # post-update counters 3, 6, 9
    s0 = train.snapshot_state(state)
    # Captures both graphs: warm-ups, captures and replays under sync_errors.
    chunk(state, cams, tgts, *consts, step0=1)
    train.restore_state(state, s0)
    torch.cuda.set_sync_debug_mode("error")
    try:
        aux = chunk(state, cams, tgts, *consts, step0=1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    replayed = train.snapshot_state(state)
    assert chunk.captures == 1 and chunk.densify_replays == 2 * len(events)
    assert int(state.scene.num_alive) > 5_000
    train.restore_state(state, s0)
    losses = []
    for i in range(K):
        losses.append(step(state, cams[i], tgts[i], *consts).loss)
        if i in events:
            densify_step(state.scene, state.opt_state, 1, state.step, optim.cap_max)
    gap, equal = fitbench._diffs(replayed, train.snapshot_state(state))
    print(f"densified replay vs eager max |diff| {gap:.3e}")
    assert equal and torch.equal(aux.loss, torch.stack(losses)), gap
    assert not bool(aux.overflow) and int(state.step) == 1 + K


def test_replays_count_the_listed_pairs_of_the_eager_steps(dev):
    """With the port's tracing on, K replays of a chunk add to
    `cull.listed_pairs` exactly what K eager steps from the same state add
    (K times one step's pairs a step), and the count adds one launch a
    replay (`listed_pairs`) to the graph of a chunk captured with tracing
    off."""
    from nlos_gaussian_renderer_tpu_torch.utils import profiling

    _, cfg, optim, settings, state, consts, cams, tgts = setup(dev)
    s0 = train.snapshot_state(state)
    off = train.make_scanned_train_step(settings, optim, cfg.sh_degree)
    off(state, cams, tgts, *consts)
    base = dict(off.launches_per_replay)
    step = train.make_train_step(settings, optim, cfg.sh_degree)
    chunk = train.make_scanned_train_step(settings, optim, cfg.sh_degree)
    profiling.enable_tracing(True)
    try:
        train.restore_state(state, s0)
        profiling.reset()
        per_step = []
        for i in range(K):
            step(state, cams[i], tgts[i], *consts)
            per_step.append(profiling.snapshot()["counters"]["cull.listed_pairs"])
        train.restore_state(state, s0)
        chunk(state, cams, tgts, *consts)  # captures; its warm-up step counts too
        train.restore_state(state, s0)
        profiling.reset()
        chunk(state, cams, tgts, *consts)
        replayed = profiling.snapshot()["counters"]["cull.listed_pairs"]
    finally:
        profiling.enable_tracing(False)
        profiling.reset()
    print(f"listed pairs a step (eager): {per_step}; K replays: {replayed}")
    assert chunk.captures == 1 and per_step[0] > 0
    assert replayed == per_step[-1]
    on = chunk.launches_per_replay
    assert on["listed_pairs"] == 1 and "listed_pairs" not in base
    assert {k: v for k, v in on.items() if k != "listed_pairs"} == base


def test_listed_pairs_kernel_equals_its_plain_version(dev):
    """The counting kernel on the 5k scene's lists at three scan points: it
    adds (twice, here) the plain version's count, which the CPU tests hold
    to `tools/kernel_work`'s pairs."""
    from nlos_gaussian_renderer_tpu_torch.ops import fused_rsort as fr
    from nlos_gaussian_renderer_tpu_torch.ops.sampling import shell_grid

    data, _, _, settings, state, consts, cams, _ = setup(dev)
    spec, sc = settings.rsort_spec, state.scene
    for cam in cams[:3, 0]:
        grid = shell_grid(cam, consts[0], settings.num_sampling_points, settings.start,
                          settings.end, data.c, data.deltaT)
        tiles = fr.rsort_cull(sc.means, sc.scales, sc.alive, cam, grid.theta, grid.phi,
                              grid.r, spec, settings.scaling_modifier)
        ns = grid.theta.shape[0]
        geo = fr.RSortGeometry(fr._cdiv(ns, spec.t_theta), fr._cdiv(ns, spec.t_phi),
                               fr._cdiv(grid.r.shape[0], spec.t_chunk), spec.t_chunk,
                               spec.g_tile, spec.t_theta * spec.t_phi)
        words = tiles.words.reshape(-1).contiguous()
        total = torch.zeros(1, dtype=torch.int64, device=dev)
        for _ in range(2):
            fr.listed_pairs(tiles.fwd, tiles.n_items, words, geo, total)
        plain = fr._listed_pairs_plain(tiles.fwd.cpu(), tiles.n_items.cpu(), words.cpu(), geo)
        assert int(total) == 2 * int(plain) > 0, (int(total), int(plain))
