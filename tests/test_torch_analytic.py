"""PyTorch port vs the JAX package: the `analytic` backend and the helpers of
`pallas_analytic` (quad slab, tile anchors, chunk edges), plus the renderer
names `RenderSettings.from_config` maps.

Shapes follow tests/test_fused_analytic.py: 8x8 rays, bins 60..140, SPEC
(t_theta=4, t_phi=8, t_chunk=8, g_tile=32, w_max=256, max_groups=16).
Identical numpy inputs go to both packages. Tolerances: the helpers within
1e-5 of JAX; the dense analytic histogram rel_l2 <= 1e-5 and its gradients
rel_l2 <= 1e-4 (quaternions 4e-4, the f32 floor tests/test_torch_render.py
measured). The scene has converged-scene scales (sigma 5-14 cm), where the
uncentred global-frame form a - b^2/(4c) cancels least; tests of the
kernels' path use the thin scene of tests/test_fused_analytic.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlos_gaussian_renderer_tpu.configs.default import Config as JConfig
from nlos_gaussian_renderer_tpu.models.scene import GaussianScene as JScene
from nlos_gaussian_renderer_tpu.ops import analytic as ja
from nlos_gaussian_renderer_tpu.ops import fused_analytic as jfa
from nlos_gaussian_renderer_tpu.ops import fused_rsort as jfr
from nlos_gaussian_renderer_tpu.ops import math as jm
from nlos_gaussian_renderer_tpu.ops.render import RenderSettings as JSettings
from nlos_gaussian_renderer_tpu.ops.render import mse_loss as j_mse
from nlos_gaussian_renderer_tpu.ops.render import render_transient as j_render
from nlos_gaussian_renderer_tpu.ops.sampling import shell_grid as j_grid
from nlos_gaussian_renderer_tpu_torch.configs.default import Config
from nlos_gaussian_renderer_tpu_torch.models.scene import PARAM_NAMES, scene_from_numpy
from nlos_gaussian_renderer_tpu_torch.ops import analytic as ta
from nlos_gaussian_renderer_tpu_torch.ops import fused_analytic as tfa
from nlos_gaussian_renderer_tpu_torch.ops import fused_rsort as tfr
from nlos_gaussian_renderer_tpu_torch.ops import math as tm
from nlos_gaussian_renderer_tpu_torch.ops.render import (
    RenderSettings,
    mse_loss,
    render_transient,
)
from nlos_gaussian_renderer_tpu_torch.ops.sampling import shell_grid

torch.set_num_threads(1)
VOL = np.array([0.0, 1.0, 0.0], np.float32)
C, DT = 1.0, 0.01
CAM = np.array([0.05, 0.0, -0.1], np.float32)
J_BOX = jm.volume_box_points(jnp.asarray(VOL), 0.6)
T_BOX = tm.volume_box_points(VOL, 0.6, device="cpu")
SPEC_KW = dict(t_theta=4, t_phi=8, t_chunk=8, g_tile=32, w_max=256, max_groups=16)


def scene_np(n=40, seed=0, log_scale=(-3.0, -2.0)):
    rng = np.random.default_rng(seed)
    rho = rng.uniform(0.2, 0.8, size=(n, 1)).astype(np.float32)
    return {
        "means": (VOL + rng.uniform(-0.25, 0.25, size=(n, 3))).astype(np.float32),
        "log_scales": rng.uniform(*log_scale, (n, 3)).astype(np.float32),
        "quats": rng.normal(size=(n, 4)).astype(np.float32),
        "logit_opacities": rng.normal(size=(n, 1)).astype(np.float32),
        "sh_dc": ((rho - 0.5) / jm.C0).astype(np.float32),
        "sh_rest": (0.1 * rng.normal(size=(n, 3))).astype(np.float32),
        "alive": (rng.random(n) > 0.1).astype(np.float32),
    }


def both(d):
    return JScene(**{k: jnp.asarray(v) for k, v in d.items()}), scene_from_numpy(d, "cpu")


def grids(cam=CAM):
    return (j_grid(jnp.asarray(cam), J_BOX, 8, 60, 140, C, DT),
            shell_grid(torch.as_tensor(cam), T_BOX, 8, 60, 140, C, DT))


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def close(got, ref, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=tol, atol=tol)


def test_ray_quadratics_and_section_integrals_match_jax():
    js, ts = both(scene_np(24, 1))
    jg, tg = grids()
    dirs = np.asarray(tg.points[0] - torch.as_tensor(CAM))
    dirs = (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).reshape(-1, 3)
    ja_, jb, jc = ja.ray_quadratics(js, jnp.asarray(CAM), jnp.asarray(dirs), 1.2)
    with torch.no_grad():
        a, b, c = ta.ray_quadratics(ts, torch.as_tensor(CAM), torch.as_tensor(dirs), 1.2)
    for got, ref in ((a, ja_), (b, jb), (c, jc)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)
    edges = np.asarray(ja.bin_edges_from_grid(jg.r))
    close(ta.bin_edges_from_grid(tg.r).numpy(), edges)
    jt = ja.section_bin_integrals(ja_, jb, jc, jnp.asarray(edges))
    tt = ta.section_bin_integrals(torch.tensor(np.asarray(ja_)), torch.tensor(np.asarray(jb)),
                                  torch.tensor(np.asarray(jc)), torch.tensor(edges))
    assert tt.shape == (80, 64, 24) and np.asarray(jt).max() > 0
    close(tt.numpy(), jt)


@pytest.mark.parametrize("t_chunk", [8, 24, 80])
def test_tile_aux_chunk_edges_and_quad_slab_match_jax(t_chunk):
    """24 bins a chunk pads the last chunk (edges continue by the step)."""
    jspec = jfr.RSortSpec(**{**SPEC_KW, "t_chunk": t_chunk})
    tspec = tfr.RSortSpec(**{**SPEC_KW, "t_chunk": t_chunk})
    jg, tg = grids()
    n_ch = -(-80 // t_chunk)
    close(tfa.chunk_edges(tg.r, tspec).numpy(), jfa.chunk_edges(jg.r, jspec))
    cam = torch.as_tensor(CAM)
    aux4 = tfa.analytic_tile_aux(tg.theta, tg.phi, tg.r, cam, tspec)
    j_aux4 = jfa.analytic_tile_aux(jg.points, jnp.asarray(CAM), 8, 80, jspec)
    if 80 % t_chunk == 0:  # JAX zero-pads the points of a partial chunk
        close(aux4.numpy(), j_aux4)
    slab = tfa.analytic_quad_slabs(tg.theta, tg.phi, torch.tensor(np.asarray(j_aux4)),
                                   tspec, n_ch)
    j_slab = np.asarray(jfa.analytic_quad_slabs(jg.theta, jg.phi, j_aux4, jspec, n_ch))
    s = tspec.t_theta * tspec.t_phi
    assert slab.shape == (n_ch * 2, 30, s)
    for blk in range(3):
        close(slab[:, 10 * blk:10 * blk + 10].numpy(), j_slab[:, :10, blk * s:(blk + 1) * s])


MODES = [(False, "netf"), (True, "netf"), (True, "nlos-neus")]


@pytest.mark.parametrize("occ,rtype", MODES)
def test_dense_analytic_histogram_matches_jax(occ, rtype):
    js, ts = both(scene_np(48, 3))
    kw = dict(num_sampling_points=8, start=60, end=140, occlusion=occ,
              rendering_type=rtype, backend="analytic")
    jr, jh, _ = j_render(js, jnp.asarray(CAM), J_BOX, C, DT, jnp.asarray(VOL), 1,
                         JSettings(**kw))
    for chunk in (None, 7):  # chunking changes only the summation order
        with torch.no_grad():
            tr, th, ov = render_transient(ts, torch.as_tensor(CAM), T_BOX, C, DT,
                                          torch.as_tensor(VOL), 1, RenderSettings(**kw),
                                          gauss_chunk=chunk)
        assert not bool(ov) and np.asarray(jh).max() > 0
        assert rel_l2(th, jh) <= 1e-5, rel_l2(th, jh)
        assert rel_l2(tr, jr) <= 1e-5


@pytest.mark.parametrize("occ", [False, True])
def test_dense_analytic_grads_of_six_groups_match_jax(occ):
    js, ts = both(scene_np(32, 4))
    kw = dict(num_sampling_points=8, start=60, end=140, occlusion=occ, backend="analytic")
    target = np.full(80, 0.1, np.float32)

    def jloss(sc):
        _, h, _ = j_render(sc, jnp.asarray(CAM), J_BOX, C, DT, jnp.asarray(VOL), 1,
                           JSettings(**kw))
        return j_mse(h, jnp.asarray(target))[0]

    jg = jax.grad(jloss)(js)
    _, h, _ = render_transient(ts, torch.as_tensor(CAM), T_BOX, C, DT, torch.as_tensor(VOL),
                               1, RenderSettings(**kw), gauss_chunk=9)
    mse_loss(h, torch.as_tensor(target))[0].backward()
    for name in PARAM_NAMES:
        a, b = getattr(ts, name).grad.numpy(), np.asarray(getattr(jg, name))
        assert np.abs(b).max() > 0, name
        tol = 4e-4 if name == "quats" else 1e-4
        assert rel_l2(a, b) <= tol, (name, rel_l2(a, b))


def test_analytic_per_gaussian_occlusion_raises():
    """The analytic field has no per_gaussian mode (JAX's raises too); a
    direct call raises, and `render_transient` renders the mode with the
    Gaussian-chunked field instead (tests/test_torch_occlusion.py)."""
    _, ts = both(scene_np(8, 2))
    st = RenderSettings(num_sampling_points=8, start=60, end=140, occlusion=True,
                        occlusion_mode="per_gaussian", backend="analytic")
    cam = torch.as_tensor(CAM)
    grid = shell_grid(cam, T_BOX, 8, 60, 140, C, DT)
    with pytest.raises(NotImplementedError):
        ta.analytic_field_response(ts, grid, cam, C, DT, 1, st)
    _, hist, ov = render_transient(ts, cam, T_BOX, C, DT, torch.as_tensor(VOL), 1, st)
    assert torch.isfinite(hist).all() and not bool(ov)


@pytest.mark.parametrize("renderer", ["dense", "pallas", "pallas_rsort", "pallas_analytic",
                                      "pallas_dsort", "analytic", "cuda_section"])
def test_from_config_maps_renderer_names_as_jax_does(renderer):
    """Every renderer name JAX keeps stays; any other trains densely."""
    j = JSettings.from_config(JConfig(renderer=renderer))
    t = RenderSettings.from_config(Config(renderer=renderer))
    assert t.backend == j.backend
    assert (t.rsort_spec.t_chunk, t.rsort_spec.gate_bins) == (
        j.rsort_spec.t_chunk, j.rsort_spec.gate_bins)
