"""Frozen rsort layouts and per_gaussian occlusion on the card.

Marked `cuda`: each test skips (from its fixture) where no GPU is present.
On the card: `python -m pytest tests/test_torch_layout_cuda.py -m cuda
--noconftest`. The scene is `prepare_training`'s on the committed Zaragoza
artifact at 5k Gaussians (`pallas_rsort`, 32x32 angles, 200 bins, B 1), as
in tests/test_torch_fit_cuda.py:

  - a frozen-layout chunk of 8 (the layout's graph replayed once, then the
    step's 8 times) equals the layout built eagerly and 8 eager steps
    through it, bit for bit; run again from the same snapshot (the overflow
    gate's replay) it rebuilds the same layout and gives the same bits; the
    step's graph launches no sort kernel, the layout's does;
  - K1 on a padded table whose blocks mix rect words and word 0 (a layout
    from one camera culled at another) equals `_cull_reduce_plain` exactly;
  - a per_gaussian chunk of 8 (the Gaussian-chunked field, each chunk
    recomputed in the backward, captured) equals 8 eager steps bit for bit.
"""

import numpy as np
import pytest
import torch

from nlos_gaussian_renderer_tpu_torch import train
from nlos_gaussian_renderer_tpu_torch.configs.default import OptimizationParams
from nlos_gaussian_renderer_tpu_torch.data.zaragoza import load_zaragoza256_data
from nlos_gaussian_renderer_tpu_torch.ops import fused_rsort as fr
from nlos_gaussian_renderer_tpu_torch.ops import math as gmath
from nlos_gaussian_renderer_tpu_torch.ops.gaussian_rows import channel_weights
from nlos_gaussian_renderer_tpu_torch.ops.sampling import shell_grid
from nlos_gaussian_renderer_tpu_torch.tools import fitbench

pytestmark = pytest.mark.cuda
K = 8


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs and kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def setup(dev, **cfg_kw):
    data = load_zaragoza256_data(fitbench.ARTIFACT)
    cfg = fitbench.config(data, gaussians=5_000, **cfg_kw)
    optim = OptimizationParams()
    scene, tx, settings, box = train.prepare_training(cfg, optim, data, device=dev)
    state = train.create_train_state(scene, tx)
    consts = (box, data.c, data.deltaT, torch.as_tensor(data.volume_position, device=dev))
    cams, tgts = fitbench._batches(cfg, data, K, dev)
    return data, cfg, optim, settings, state, consts, cams, tgts


def test_layout_chunk_replay_equals_eager_bit_for_bit(dev):
    data, cfg, optim, settings, state, consts, cams, tgts = setup(dev, frozen_layout=True)
    ref_cam, slack = train.layout_reference(data)
    chunk = train.make_scanned_train_step(settings, optim, cfg.sh_degree, ref_cam=ref_cam,
                                          layout_slack=slack)
    step = train.make_train_step(settings, optim, cfg.sh_degree)
    s0 = train.snapshot_state(state)
    aux = chunk(state, cams, tgts, *consts)
    replayed = train.snapshot_state(state)
    assert not bool(aux.overflow) and chunk.captures == 1 and chunk.layout_replays == 1
    assert all(chunk.launches_per_replay.get(k, 0) >= 1 for k in fitbench.RSORT_KERNELS)
    train.restore_state(state, s0)
    lay = chunk.layout(state, *consts[:3])
    losses = [step(state, cams[i], tgts[i], *consts, layout=lay).loss for i in range(K)]
    _, equal = fitbench._diffs(replayed, train.snapshot_state(state))
    assert equal and torch.equal(aux.loss, torch.stack(losses))
    train.restore_state(state, s0)
    aux2 = chunk(state, cams, tgts, *consts)  # the gate's replay: the layout rebuilt
    assert chunk.captures == 1 and chunk.layout_replays == 2
    assert fitbench._diffs(replayed, train.snapshot_state(state))[1]
    assert torch.equal(aux2.loss, aux.loss)
    train.restore_state(state, s0)
    events = fitbench.graph_events(chunk)
    assert events["step"]["sort_events"] == 0, events["step"]
    assert events["layout"]["sort_events"] >= 1, events["layout"]


@torch.no_grad()
def test_cull_reduce_on_a_layout_mixing_words_equals_plain(dev):
    data, cfg, _, settings, state, _, _, _ = setup(dev, frozen_layout=True)
    sc, spec = state.scene, settings.rsort_spec
    box = gmath.volume_box_points(data.volume_position, data.volume_size, device=dev)
    ref_cam, slack = train.layout_reference(data)
    ref = torch.as_tensor(ref_cam, device=dev)
    g0 = shell_grid(ref, box, cfg.num_sampling_points, cfg.start, cfg.end, data.c,
                    data.deltaT)
    lay = fr.rsort_layout(sc.means, sc.scales, sc.alive, ref, g0.theta, g0.phi, g0.r, spec,
                          slack=slack)
    cam = torch.as_tensor(data.camera_grid_positions[:, 0], device=dev)  # a corner
    grid = shell_grid(cam, box, cfg.num_sampling_points, cfg.start, cfg.end, data.c,
                      data.deltaT)
    w = channel_weights(sc, cam, 0, settings)
    gw = torch.cat([sc.quadratic_form(), w], 1)
    tiles = fr.rsort_cull(sc.means, sc.scales, sc.alive, cam, grid.theta, grid.phi, grid.r,
                          spec, gw=gw, layout=lay)
    words = tiles.words.reshape(-1, spec.g_tile)
    distinct = [len(set(b.tolist()) - {0}) for b in words]
    has_zero = (words == 0).any(1)
    # Blocks that hold two or more rect words and word-0 slots of rows this
    # camera culls (the layout's slots are not this camera's groups).
    assert any(n >= 2 and z for n, z in zip(distinct, has_zero.tolist()))
    n_tt = -(-cfg.num_sampling_points // spec.t_theta)
    n_pt = -(-cfg.num_sampling_points // spec.t_phi)
    tb = -(-(cfg.end - cfg.start) // spec.t_chunk) * spec.t_chunk
    args = (tiles.table.detach(), gw.shape[1], spec.g_tile, grid.r, n_tt, n_pt, tb)
    got, ref_out = fr.cull_reduce(*args), fr._cull_reduce_plain(*args)
    for a, b in zip(got, ref_out):
        assert torch.equal(a, b)


def test_per_gaussian_chunk_replay_equals_eager_bit_for_bit(dev):
    _, cfg, optim, settings, state, consts, cams, tgts = setup(
        dev, occlusion=True, occlusion_mode="per_gaussian")
    assert settings.backend == "pallas_rsort"
    chunk = train.make_scanned_train_step(settings, optim, cfg.sh_degree)
    step = train.make_train_step(settings, optim, cfg.sh_degree)
    s0 = train.snapshot_state(state)
    aux = chunk(state, cams, tgts, *consts)
    replayed = train.snapshot_state(state)
    assert not bool(aux.overflow) and chunk.captures == 1
    assert not chunk.launches_per_replay  # no kernel: the chunked field is tensor code
    train.restore_state(state, s0)
    losses = [step(state, cams[i], tgts[i], *consts).loss for i in range(K)]
    _, equal = fitbench._diffs(replayed, train.snapshot_state(state))
    assert equal and torch.equal(aux.loss, torch.stack(losses))
    assert bool(torch.isfinite(aux.loss).all()) and np.isfinite(float(aux.loss[-1]))
