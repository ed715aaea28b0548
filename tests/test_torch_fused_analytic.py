"""PyTorch port vs the JAX package: the `pallas_analytic` field, gradients
and train step through the K5/K6 plain versions (CPU tensors).

Shapes and the thin scene (sigma 1.8-8 cm) follow
tests/test_fused_analytic.py: 8x8 rays, bins 60..140, SPEC (t_theta=4,
t_phi=8, t_chunk=8, g_tile=32, w_max=256, max_groups=16). Tolerances are
that file's: histograms rtol 3e-3 against JAX dense `analytic` and
gradients atol 7e-3 of scale. The port covers exactly each item's bins
[bl, bh], where the JAX gate ladder over-covers the leading cull-tail bins,
so at the default 3-sigma cull the histogram is held by rel_l2 and bin by
bin only with a 6-sigma cull. The moment backward is held to autograd
through the plain forward in float64 at rel 1e-8, independently of JAX."""

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
from nlos_gaussian_renderer_tpu_torch.configs.default import OptimizationParams
from nlos_gaussian_renderer_tpu_torch.models.scene import PARAM_NAMES, scene_from_numpy
from nlos_gaussian_renderer_tpu_torch.ops import fused_analytic as tfa
from nlos_gaussian_renderer_tpu_torch.ops import fused_rsort as tfr
from nlos_gaussian_renderer_tpu_torch.ops import math as tm
from nlos_gaussian_renderer_tpu_torch.ops.gaussian_rows import channel_weights
from nlos_gaussian_renderer_tpu_torch.ops.render import (
    RenderSettings,
    mse_loss,
    render_transient,
)
from nlos_gaussian_renderer_tpu_torch.ops.sampling import shell_grid
from nlos_gaussian_renderer_tpu_torch.train import create_train_state, make_train_step

torch.set_num_threads(1)
VOL = np.array([0.0, 1.0, 0.0], np.float32)
C, DT = 1.0, 0.01
CAM = np.array([0.05, 0.0, -0.1], np.float32)
J_BOX = jm.volume_box_points(jnp.asarray(VOL), 0.6)
T_BOX = tm.volume_box_points(VOL, 0.6, device="cpu")
SPEC_KW = dict(t_theta=4, t_phi=8, t_chunk=8, g_tile=32, w_max=256, max_groups=16)
J_SPEC = jfr.RSortSpec(**SPEC_KW)
T_SPEC = tfr.RSortSpec(**SPEC_KW)


def scene_np(n=40, seed=0):
    """The random scene of tests/test_fused_analytic.py, as numpy arrays."""
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


def settings(occ=False, **spec):
    kw = dict(num_sampling_points=8, start=60, end=140, occlusion=occ)
    return (RenderSettings(**kw, backend="pallas_analytic", rsort_spec=T_SPEC._replace(**spec)),
            JSettings(**kw, backend="analytic"))


def t_render(ts, st, cam=CAM):
    return render_transient(ts, torch.as_tensor(cam), T_BOX, C, DT, torch.as_tensor(VOL), 1, st)


def j_hist(js, st, cam=CAM):
    return np.asarray(j_render(js, jnp.asarray(cam), J_BOX, C, DT, jnp.asarray(VOL), 1, st)[1])


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


@pytest.mark.parametrize("occ", [False, True])
def test_plain_analytic_histogram_matches_jax_dense_analytic(occ):
    js, ts = both(scene_np(48, 3))
    hd = j_hist(js, settings(occ)[1])
    for sigma_cull in (3.0, 6.0):
        st = settings(occ, sigma_cull=sigma_cull, w_max=1024)[0]
        with torch.no_grad():
            _, hk, ov = t_render(ts, st)
        assert not bool(ov)
        assert rel_l2(hk, hd) <= 3e-3, (sigma_cull, rel_l2(hk, hd))
        if sigma_cull == 6.0:
            np.testing.assert_allclose(hk.numpy(), hd, rtol=3e-3, atol=1e-9)


@pytest.mark.parametrize("occ", [False, True])
def test_plain_analytic_grads_match_jax_dense_analytic(occ):
    js, ts = both(scene_np(32, 5))
    tset, jset = settings(occ)
    target = np.full(80, 0.1, np.float32)

    def jloss(sc):
        _, h, _ = j_render(sc, jnp.asarray(CAM), J_BOX, C, DT, jnp.asarray(VOL), 1, jset)
        return j_mse(h, jnp.asarray(target))[0]

    jg = jax.grad(jloss)(js)
    _, h, ov = t_render(ts, tset)
    assert not bool(ov)
    mse_loss(h, torch.as_tensor(target))[0].backward()
    for name in PARAM_NAMES:
        a, b = getattr(ts, name).grad.numpy(), np.asarray(getattr(jg, name))
        scale = np.abs(b).max() + 1e-12
        np.testing.assert_allclose(a / scale, b / scale, atol=7e-3, err_msg=name)


def _kernel_operands(occ, dtype):
    """K5/K6 operands of one cull of the thin scene, in `dtype`."""
    ts = scene_from_numpy(scene_np(48, 3), "cpu")
    cam = torch.as_tensor(CAM)
    grid = shell_grid(cam, T_BOX, 8, 60, 140, C, DT)
    st = settings(occ)[0]
    with torch.no_grad():
        w = channel_weights(ts, cam, 1, st)
        gfeat = ts.quadratic_form()
        tiles = tfr.rsort_cull(ts.means, ts.scales, ts.alive, cam, grid.theta, grid.phi,
                               grid.r, T_SPEC, gw=torch.cat([gfeat, w], 1))
    geo = tfr.RSortGeometry(2, 1, 10, 8, 32, 32)
    f = [x.to(dtype) for x in (*tfa.analytic_operands(grid, cam, T_SPEC), tiles.table)]
    return f, tiles, geo, w.shape[1]


@pytest.mark.parametrize("occ", [False, True])
def test_analytic_bwd_plain_equals_autograd_of_fwd_plain_in_float64(occ):
    (slab, aux, edges, table), tiles, geo, c = _kernel_operands(occ, torch.float64)
    words = tiles.words.reshape(-1)
    table = table.detach().requires_grad_(True)
    out = tfa._analytic_fwd_plain(slab, aux, edges, table, words, tiles.fwd, tiles.n_items,
                                  geo, c)
    go = torch.as_tensor(np.random.default_rng(0).normal(size=out.shape))
    (ref,) = torch.autograd.grad((out * go).sum(), table)
    got = tfa._analytic_bwd_plain(slab, aux, edges, table.detach(), words, tiles.bwd,
                                  tiles.n_items, go, geo, c)
    assert float(ref.abs().max()) > 0 and int(tiles.n_items[0]) > 0
    assert rel_l2(got, ref) <= 1e-8, rel_l2(got, ref)


def test_analytic_overflow_flag_reaches_output():
    _, ts = both(scene_np(48, 7))
    with torch.no_grad():
        _, _, ov = t_render(ts, settings(w_max=2)[0])
    assert bool(ov)


def test_analytic_train_steps_stay_finite_without_overflow():
    ts = scene_from_numpy(scene_np(48, 6), "cpu")
    spec = tfr.tune_rsort_spec(ts, np.array([[0.05, 0.0, -0.1], [0.2, 0.0, 0.1]]),
                               T_BOX, 8, 60, 140, C, DT, base=T_SPEC)
    tset = settings()[0]._replace(rsort_spec=spec)
    optim = OptimizationParams()
    state = create_train_state(ts, optim)
    step = make_train_step(tset, optim, max_sh_degree=1)
    rng = np.random.default_rng(0)
    before = ts.means.detach().clone()
    for _ in range(3):
        cam = torch.tensor([[rng.uniform(-0.1, 0.1), 0.0, rng.uniform(-0.1, 0.1)]],
                           dtype=torch.float32)
        aux = step(state, cam, torch.full((1, 80), 0.05), T_BOX, C, DT, torch.as_tensor(VOL))
        assert np.isfinite(float(aux.loss)) and not bool(aux.overflow)
    assert state.step == 4
    assert torch.isfinite(ts.means).all() and not torch.equal(ts.means, before)
