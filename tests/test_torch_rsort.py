"""PyTorch port vs the JAX package: the `pallas_rsort` cull, work lists,
field and train step, through the kernels' plain versions (CPU tensors).

Shapes follow tests/test_rsort.py: 32-64 Gaussians, 8x8 rays, bins 60..140,
SPEC (t_theta=4, t_phi=8, t_chunk=8, g_tile=32, w_max=256, max_groups=16).
Tolerances: layouts, words and work lists exactly equal (JAX's own cull
geometry is fed to the port's scheduler, so no arcsin last-ulp can reorder a
sort); histograms rtol 3e-3 and gradients atol 7e-3 of scale against JAX
dense, as tests/test_rsort.py holds the JAX kernels (the histogram bin by
bin with the cull tail removed, see its test)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlos_gaussian_renderer_tpu.models.scene import GaussianScene as JScene
from nlos_gaussian_renderer_tpu.ops import fused_rsort as jfr
from nlos_gaussian_renderer_tpu.ops import math as jm
from nlos_gaussian_renderer_tpu.ops.render import RenderSettings as JSettings
from nlos_gaussian_renderer_tpu.ops.render import mse_loss as j_mse
from nlos_gaussian_renderer_tpu.ops.render import render_transient as j_render
from nlos_gaussian_renderer_tpu.ops.sampling import shell_grid as j_grid
from nlos_gaussian_renderer_tpu_torch.configs.default import OptimizationParams
from nlos_gaussian_renderer_tpu_torch.models.scene import PARAM_NAMES, scene_from_numpy
from nlos_gaussian_renderer_tpu_torch.ops import fused_rsort as tfr
from nlos_gaussian_renderer_tpu_torch.ops import math as tm
from nlos_gaussian_renderer_tpu_torch.ops.render import (
    RenderSettings,
    mse_loss,
    render_transient,
)
from nlos_gaussian_renderer_tpu_torch.ops.sampling import shell_grid
from nlos_gaussian_renderer_tpu_torch.train import (
    create_train_state,
    make_train_step,
    restore_state,
    snapshot_state,
)

torch.set_num_threads(1)
VOL = np.array([0.0, 1.0, 0.0], np.float32)
C, DT = 1.0, 0.01
CAM = np.array([0.05, 0.0, -0.1], np.float32)
J_BOX = jm.volume_box_points(jnp.asarray(VOL), 0.6)
T_BOX = tm.volume_box_points(VOL, 0.6, device="cpu")
SPEC_KW = dict(t_theta=4, t_phi=8, t_chunk=8, g_tile=32, w_max=256, max_groups=16)
J_SPEC = jfr.RSortSpec(**SPEC_KW)
T_SPEC = tfr.RSortSpec(**SPEC_KW)
LISTS = ("fwd_t", "fwd_j", "fwd_b", "fwd_first", "fwd_bl", "fwd_bh",
         "bwd_t", "bwd_j", "bwd_b", "bwd_first", "bwd_bl", "bwd_bh")


def scene_np(n=40, seed=0):
    """The random scene of tests/test_rsort.py, as numpy arrays."""
    rng = np.random.default_rng(seed)
    rho = rng.uniform(0.2, 0.8, size=(n, 1)).astype(np.float32)
    return {
        "means": (VOL + rng.uniform(-0.25, 0.25, size=(n, 3))).astype(np.float32),
        "log_scales": rng.uniform(-4.0, -2.5, (n, 3)).astype(np.float32),
        "quats": rng.normal(size=(n, 4)).astype(np.float32),
        "logit_opacities": rng.normal(size=(n, 1)).astype(np.float32),
        "sh_dc": ((rho - 0.5) / jm.C0).astype(np.float32),
        "sh_rest": (0.1 * rng.normal(size=(n, 3))).astype(np.float32),
        "alive": (rng.random(n) > 0.1).astype(np.float32),
    }


def both(d):
    return JScene(**{k: jnp.asarray(v) for k, v in d.items()}), scene_from_numpy(d, "cpu")


def _jax_cull(js, spec, cam=CAM):
    grid = j_grid(jnp.asarray(cam), J_BOX, 8, 60, 140, C, DT)
    args = (js.means, js.scales, js.alive, jnp.asarray(cam), grid.theta, grid.phi, grid.r)
    return jfr.rsort_cull(*args, spec), jfr._cull_geometry(*args, spec), grid


def _port_schedule_on_jax_geometry(geom, grid, spec):
    d, radius, word, valid_g, counts = (torch.tensor(np.asarray(a)) for a in geom)
    return tfr.rsort_schedule(d, radius, word.to(torch.int32), valid_g, counts,
                              torch.tensor(np.asarray(grid.r)), 2, 1, spec)


def _assert_lists_equal(tj, tt):
    n = int(tj.n_items[0])
    assert int(tt.n_items[0]) == n
    for f in LISTS:
        np.testing.assert_array_equal(getattr(tt, f).numpy()[:n],
                                      np.asarray(getattr(tj, f))[:n], err_msg=f)
    np.testing.assert_array_equal(tt.words.numpy(), np.asarray(tj.words))
    np.testing.assert_array_equal(tt.full_perm.numpy(), np.asarray(tj.full_perm))
    np.testing.assert_array_equal(tt.inv_perm.numpy(), np.asarray(tj.inv_perm))
    np.testing.assert_array_equal(tt.counts.numpy(), np.asarray(tj.counts))
    assert int(tt.n_groups) == int(tj.n_groups)
    assert bool(tt.overflowed) == bool(tj.overflowed)


@pytest.mark.parametrize("seed", [1, 21])
def test_layout_matches_jax(seed):
    js, _ = both(scene_np(64, seed))
    _, geom, grid = _jax_cull(js, J_SPEC)
    d, _, word, valid_g, _ = geom
    jl = jfr._layout_from_geometry(d, word, valid_g, 64, 2, 1, J_SPEC, d_hi=grid.r[-1])
    tl = tfr._layout_from_geometry(
        torch.tensor(np.asarray(d)), torch.tensor(np.asarray(word)),
        torch.tensor(np.asarray(valid_g)), 2, 1, T_SPEC,
        d_hi=torch.tensor(np.asarray(grid.r))[-1],
    )
    for f in ("perm", "src", "inv_perm"):
        np.testing.assert_array_equal(getattr(tl, f).numpy(), np.asarray(getattr(jl, f)),
                                      err_msg=f)
    assert int(tl.n_groups) == int(jl.n_groups)


@pytest.mark.parametrize("ws_pallas", [False, True])
@pytest.mark.parametrize("t_chunk,gate", [(8, 4), (80, 80)])
def test_cull_matches_jax(ws_pallas, t_chunk, gate):
    """Words, layout, both work lists' valid prefixes and the has-work flags,
    against the JAX XLA chain and the JAX Pallas work-list kernel (interpret
    mode)."""
    js, _ = both(scene_np(64, 21))
    jspec = J_SPEC._replace(t_chunk=t_chunk, gate_bins=gate, ws_pallas=ws_pallas)
    tj, geom, grid = _jax_cull(js, jspec)
    tt = _port_schedule_on_jax_geometry(
        geom, grid, T_SPEC._replace(t_chunk=t_chunk, gate_bins=gate))
    assert not bool(tj.overflowed) and int(tj.n_items[0]) > 0
    _assert_lists_equal(tj, tt)
    np.testing.assert_array_equal(tt.tile_has_work.numpy(), np.asarray(tj.tile_has_work))
    np.testing.assert_array_equal(tt.blk_has_work.numpy(), np.asarray(tj.blk_has_work))
    n = int(tt.n_items[0])
    assert (tt.fwd[:, n:] == 0).all() and (tt.bwd[:, n:] == 0).all()


def test_port_cull_geometry_reproduces_jax_lists():
    """The port's own geometry (torch arcsin, norms) gives the same cull on
    this scene."""
    d = scene_np(48, 3)
    js, ts = both(d)
    tj, _, _ = _jax_cull(js, J_SPEC._replace(ws_pallas=False))
    g = shell_grid(torch.as_tensor(CAM), T_BOX, 8, 60, 140, C, DT)
    tt = tfr.rsort_cull(ts.means, ts.scales, ts.alive, torch.as_tensor(CAM), g.theta,
                        g.phi, g.r, T_SPEC)
    _assert_lists_equal(tj, tt)


def test_overflow_flag_and_truncated_prefix():
    """w_max=16: the first 16 items are written, n_raw stays unclipped in the
    flag, and the has-work flags mark only written items, as the JAX Pallas
    work-list kernel does (tests/test_rsort.py:707-726)."""
    js, _ = both(scene_np(64, 22))
    jspec = J_SPEC._replace(w_max=16, ws_pallas=True)
    tj, geom, grid = _jax_cull(js, jspec)
    tt = _port_schedule_on_jax_geometry(geom, grid, T_SPEC._replace(w_max=16))
    assert bool(tj.overflowed) and bool(tt.overflowed)
    assert int(tt.n_items[0]) == int(tj.n_items[0]) == 16
    _assert_lists_equal(tj, tt)
    np.testing.assert_array_equal(tt.tile_has_work.numpy(), np.asarray(tj.tile_has_work))
    np.testing.assert_array_equal(tt.blk_has_work.numpy(), np.asarray(tj.blk_has_work))


def test_decode_rect_members_matches_jax():
    words = np.random.default_rng(0).integers(0, 1 << 11, 200).astype(np.int32)
    for n_tt, n_pt in ((2, 1), (4, 4), (3, 5)):
        ref = np.asarray(jfr.decode_rect_members(jnp.asarray(words), n_tt, n_pt))
        got = tfr.decode_rect_members(torch.as_tensor(words), n_tt, n_pt).numpy()
        np.testing.assert_array_equal(got, ref)


def test_wide_pad_gather_forward_and_inverse_gather_backward():
    rng = np.random.default_rng(7)
    g, n_gw = 5, 3
    gw = rng.normal(size=(g, n_gw)).astype(np.float32)
    geom = rng.normal(size=(g, 2)).astype(np.float32)
    perm = np.array([2, 0, 4, 1, 3])
    src = np.array([0, 1, 2, 5, 3, 5, 4, 5])
    inv_perm = np.array([1, 8, 0, 9, 2])
    ref = jfr.wide_pad_gather(jnp.asarray(gw), jnp.asarray(geom), jnp.asarray(perm),
                              jnp.asarray(src), jnp.asarray(inv_perm), n_gw)
    tgw = torch.tensor(gw, requires_grad=True)
    out = tfr.WidePadGather.apply(tgw, torch.as_tensor(geom), torch.as_tensor(perm),
                                  torch.as_tensor(src), torch.as_tensor(inv_perm))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(ref))
    go = rng.normal(size=out.shape).astype(np.float32)
    jgrad = jax.vjp(lambda w: jfr.wide_pad_gather(
        w, jnp.asarray(geom), jnp.asarray(perm), jnp.asarray(src),
        jnp.asarray(inv_perm), n_gw), jnp.asarray(gw))[1](jnp.asarray(go))[0]
    out.backward(torch.as_tensor(go))
    np.testing.assert_array_equal(tgw.grad.numpy(), np.asarray(jgrad))


def _settings(occ):
    return (RenderSettings(num_sampling_points=8, start=60, end=140, occlusion=occ,
                           backend="pallas_rsort", rsort_spec=T_SPEC),
            JSettings(num_sampling_points=8, start=60, end=140, occlusion=occ))


@pytest.mark.parametrize("occ", [False, True])
def test_plain_rsort_histogram_matches_jax_dense(occ):
    """The port covers exactly each item's bins [bl, bh] (the JAX kernels'
    gate ladder over-covers up to gate_bins - 1 bins at this tile shape), so
    the leading bins carry the true 3-sigma cull tail (up to ~10% of bins
    1e-3 of the peak): the default cull is held by rel_l2, and a 6-sigma cull,
    which removes the tail, bin by bin at rtol 3e-3 (as
    tests/test_rsort.py's lane-aligned ladder test does)."""
    js, ts = both(scene_np(48, 3))
    tset, jset = _settings(occ)
    _, hd, _ = j_render(js, jnp.asarray(CAM), J_BOX, C, DT, jnp.asarray(VOL), 1, jset)
    hd = np.asarray(hd)
    for sigma_cull in (3.0, 6.0):
        st = tset._replace(rsort_spec=T_SPEC._replace(sigma_cull=sigma_cull, w_max=1024))
        with torch.no_grad():
            _, hr, ov = render_transient(ts, torch.as_tensor(CAM), T_BOX, C, DT,
                                         torch.as_tensor(VOL), 1, st)
        assert not bool(ov)
        hr = hr.numpy()
        assert np.linalg.norm(hr - hd) <= 3e-3 * np.linalg.norm(hd)
        if sigma_cull == 6.0:
            np.testing.assert_allclose(hr, hd, rtol=3e-3, atol=1e-9)


@pytest.mark.parametrize("occ", [False, True])
def test_plain_rsort_grads_match_jax_dense(occ):
    js, ts = both(scene_np(32, 4))
    tset, jset = _settings(occ)
    target = np.full(80, 0.1, np.float32)

    def jloss(sc):
        _, h, _ = j_render(sc, jnp.asarray(CAM), J_BOX, C, DT, jnp.asarray(VOL), 1, jset)
        return j_mse(h, jnp.asarray(target))[0]

    jg = jax.grad(jloss)(js)
    _, h, ov = render_transient(ts, torch.as_tensor(CAM), T_BOX, C, DT,
                                torch.as_tensor(VOL), 1, tset)
    assert not bool(ov)
    mse_loss(h, torch.as_tensor(target))[0].backward()
    for name in PARAM_NAMES:
        a, b = getattr(ts, name).grad.numpy(), np.asarray(getattr(jg, name))
        scale = np.abs(b).max() + 1e-12
        np.testing.assert_allclose(a / scale, b / scale, atol=7e-3, err_msg=name)


def test_rsort_train_steps_stay_finite_without_overflow():
    ts = scene_from_numpy(scene_np(48, 6), "cpu")
    spec = tfr.tune_rsort_spec(ts, np.array([[0.05, 0.0, -0.1], [0.2, 0.0, 0.1]]),
                               T_BOX, 8, 60, 140, C, DT, base=T_SPEC)
    assert spec.w_max >= 8 and spec.max_groups >= 1
    tset = _settings(False)[0]._replace(rsort_spec=spec)
    optim = OptimizationParams()
    state = create_train_state(ts, optim)
    step = make_train_step(tset, optim, max_sh_degree=1, sh_anneal_interval=2)
    rng = np.random.default_rng(0)
    before = ts.means.detach().clone()
    for i in range(3):
        cam = torch.tensor([[rng.uniform(-0.1, 0.1), 0.0, rng.uniform(-0.1, 0.1)]],
                           dtype=torch.float32)
        aux = step(state, cam, torch.full((1, 80), 0.05), T_BOX, C, DT,
                   torch.as_tensor(VOL))
        assert np.isfinite(float(aux.loss)) and not bool(aux.overflow)
    assert state.step == 4 and state.active_sh_degree == 1
    assert torch.isfinite(ts.means).all() and not torch.equal(ts.means, before)


def test_rsort_train_step_raises_on_overflow_before_updating():
    """(The name predates the change.) A step whose work list overflowed
    w_max applies the update and returns the flag as a device bool, as in
    JAX; the snapshot `fit` replays from restores the state it started
    from."""
    ts = scene_from_numpy(scene_np(48, 6), "cpu")
    tset = _settings(False)[0]._replace(rsort_spec=T_SPEC._replace(w_max=4))
    optim = OptimizationParams()
    state = create_train_state(ts, optim)
    before = {n: p.detach().clone() for n, p in ts.named_parameters()}
    snap = snapshot_state(state)
    aux = make_train_step(tset, optim, max_sh_degree=1)(
        state, torch.as_tensor(CAM)[None], torch.full((1, 80), 0.05), T_BOX, C,
        DT, torch.as_tensor(VOL))
    assert aux.overflow.dtype == torch.bool and bool(aux.overflow)
    assert state.step == 2 and not torch.equal(ts.means, before["means"])
    restore_state(state, snap)
    for n, p in ts.named_parameters():
        assert torch.equal(p, before[n]), n
    assert state.step == 1
