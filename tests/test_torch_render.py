"""PyTorch port vs the JAX package: dense rendering, gradients, Adam steps.

Identical numpy scenes go through both packages' dense (plain tensor) path.
Tolerances: histograms rel_l2 <= 1e-5; gradients of the parameter groups
rel_l2 <= 1e-4, the quaternions' 4e-4; Adam steps max-abs <= 1e-6 on every
parameter. The same comparisons in float64 (JAX under `enable_x64`) hold the
formulas to 1e-10, free of f32 noise.

The dense path evaluates the quadratic form uncentred, in world
coordinates ~1 m from the origin, so an f32 ulp in a sample point or a form
coefficient moves q by ~(|x| / sigma)^2 ulps. XLA rounds some fused
elementwise ops (linspace, norms) differently from PyTorch, which at the
thin scene of tests/test_rsort.py (sigma 2-8 cm) moves single samples by
~3e-5. The scenes here have sigma 5-14 cm, the converged-scene scale the
README records (~5 cm), where that amplification is ~10x smaller.

The quaternion gradient is the antisymmetric part of two nearly equal
products and carries ~1e-4 f32 error on either side: against a float64 run,
JAX's is 0.9-1.4e-4 and the port's 0.9-1.5e-4 off, so the two differ by up
to ~2.4e-4. Through Adam's normalised update, that moves a quaternion by
~1.4e-6 after three f32 steps; three steps are held to 1e-6 in float64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlos_gaussian_renderer_tpu.configs.default import OptimizationParams as JOptim
from nlos_gaussian_renderer_tpu.models.scene import GaussianScene as JScene
from nlos_gaussian_renderer_tpu.ops import math as jm
from nlos_gaussian_renderer_tpu.ops.render import RenderSettings as JSettings
from nlos_gaussian_renderer_tpu.ops.render import mse_loss as j_mse
from nlos_gaussian_renderer_tpu.ops.render import render_transient as j_render
from nlos_gaussian_renderer_tpu.train import create_train_state as j_state
from nlos_gaussian_renderer_tpu.train import make_optimizer as j_opt
from nlos_gaussian_renderer_tpu.train import make_train_step as j_step
from nlos_gaussian_renderer_tpu_torch.configs.default import OptimizationParams
from nlos_gaussian_renderer_tpu_torch.models.scene import PARAM_NAMES, scene_from_numpy
from nlos_gaussian_renderer_tpu_torch.ops import math as tm
from nlos_gaussian_renderer_tpu_torch.ops.render import (
    RenderSettings,
    mse_loss,
    render_transient,
)
from nlos_gaussian_renderer_tpu_torch.train import create_train_state, make_train_step

torch.set_num_threads(1)
VOL = np.array([0.0, 1.0, 0.0], np.float32)
C, DT = 1.0, 0.01
CAM = np.array([0.05, 0.0, -0.1], np.float32)
J_BOX = jm.volume_box_points(jnp.asarray(VOL), 0.6)
T_BOX = tm.volume_box_points(VOL, 0.6, device="cpu")


def scene_np(n=40, seed=0, sh_degree=1):
    """The random scene of tests/test_rsort.py as numpy arrays, with
    converged-scene scales (sigma 5-14 cm)."""
    rng = np.random.default_rng(seed)
    k = (sh_degree + 1) ** 2
    rho = rng.uniform(0.2, 0.8, size=(n, 1)).astype(np.float32)
    return {
        "means": (VOL + rng.uniform(-0.25, 0.25, size=(n, 3))).astype(np.float32),
        "log_scales": rng.uniform(-3.0, -2.0, (n, 3)).astype(np.float32),
        "quats": rng.normal(size=(n, 4)).astype(np.float32),
        "logit_opacities": rng.normal(size=(n, 1)).astype(np.float32),
        "sh_dc": ((rho - 0.5) / jm.C0).astype(np.float32),
        "sh_rest": (0.1 * rng.normal(size=(n, k - 1))).astype(np.float32),
        "alive": (rng.random(n) > 0.1).astype(np.float32),
    }


def both(d):
    return JScene(**{k: jnp.asarray(v) for k, v in d.items()}), scene_from_numpy(d, "cpu")


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


MODES = [(False, "netf"), (True, "netf"), (True, "nlos-neus")]


@pytest.mark.parametrize("occ,rtype", MODES)
def test_dense_histogram_matches_jax(occ, rtype):
    js, ts = both(scene_np(48, 3))
    jset = JSettings(num_sampling_points=8, start=60, end=140, occlusion=occ,
                     rendering_type=rtype)
    tset = RenderSettings(num_sampling_points=8, start=60, end=140, occlusion=occ,
                          rendering_type=rtype)
    jr, jh, _ = j_render(js, jnp.asarray(CAM), J_BOX, C, DT, jnp.asarray(VOL), 1, jset)
    with torch.no_grad():
        tr, th, ov = render_transient(ts, torch.as_tensor(CAM), T_BOX, C, DT,
                                      torch.as_tensor(VOL), 1, tset)
    assert not bool(ov)
    assert rel_l2(th, jh) <= 1e-5
    assert rel_l2(tr, jr) <= 1e-5
    # Chunking the sum over Gaussians changes only the summation order.
    with torch.no_grad():
        _, thc, _ = render_transient(ts, torch.as_tensor(CAM), T_BOX, C, DT,
                                     torch.as_tensor(VOL), 1, tset, gauss_chunk=7)
    assert rel_l2(thc, jh) <= 1e-5


def _grads(d, occ, dtype):
    """(JAX grads, port grads) of the MSE against a flat target."""
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    d = {k: v.astype(np_dt) for k, v in d.items()}
    target = np.full(80, 0.1, np_dt)
    jset = JSettings(num_sampling_points=8, start=60, end=140, occlusion=occ)
    tset = RenderSettings(num_sampling_points=8, start=60, end=140, occlusion=occ)
    with jax.enable_x64(dtype == torch.float64):
        js = JScene(**{k: jnp.asarray(v) for k, v in d.items()})
        box = jm.volume_box_points(jnp.asarray(VOL.astype(np_dt)), 0.6)

        def jloss(sc):
            _, h, _ = j_render(sc, jnp.asarray(CAM.astype(np_dt)), box, C, DT,
                               jnp.asarray(VOL.astype(np_dt)), 1, jset)
            return j_mse(h, jnp.asarray(target))[0]

        jg = jax.grad(jloss)(js)
        jg = {n: np.asarray(getattr(jg, n)) for n in PARAM_NAMES}
    ts = scene_from_numpy(d, "cpu").to(dtype)
    _, h, _ = render_transient(ts, torch.as_tensor(CAM.astype(np_dt)),
                               tm.volume_box_points(VOL.astype(np_dt), 0.6, device="cpu"), C, DT,
                               torch.as_tensor(VOL.astype(np_dt)), 1, tset,
                               gauss_chunk=9)
    mse_loss(h, torch.as_tensor(target))[0].backward()
    return jg, {n: getattr(ts, n).grad.numpy() for n in PARAM_NAMES}


@pytest.mark.parametrize("occ", [False, True])
def test_dense_grads_of_six_groups_match_jax(occ):
    jg, tg = _grads(scene_np(32, 4), occ, torch.float32)
    for name in PARAM_NAMES:
        assert np.abs(jg[name]).max() > 0, name
        tol = 4e-4 if name == "quats" else 1e-4
        assert rel_l2(tg[name], jg[name]) <= tol, (name, rel_l2(tg[name], jg[name]))


@pytest.mark.parametrize("occ", [False, True])
def test_dense_grads_match_jax_in_float64(occ):
    jg, tg = _grads(scene_np(32, 4), occ, torch.float64)
    for name in PARAM_NAMES:
        assert tg[name].dtype == jg[name].dtype == np.float64
        assert rel_l2(tg[name], jg[name]) <= 1e-10, (name, rel_l2(tg[name], jg[name]))


@pytest.mark.parametrize("dtype,n_steps", [(torch.float32, 1), (torch.float64, 1),
                                           (torch.float64, 3)])
def test_adam_steps_match_jax_dense_train_step(dtype, n_steps):
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    d = {k: v.astype(np_dt) for k, v in scene_np(24, 5).items()}
    rng = np.random.default_rng(9)
    cams = [np.array([[rng.uniform(-0.2, 0.2), 0.0, rng.uniform(-0.2, 0.2)]], np_dt)
            for _ in range(n_steps)]
    targets = rng.uniform(0.0, 0.2, (n_steps, 1, 80)).astype(np_dt)
    vol = VOL.astype(np_dt)
    jset = JSettings(num_sampling_points=8, start=60, end=140)
    tset = RenderSettings(num_sampling_points=8, start=60, end=140)

    jo = JOptim(regularization=True)
    with jax.enable_x64(dtype == torch.float64):
        js = JScene(**{k: jnp.asarray(v) for k, v in d.items()})
        box = jm.volume_box_points(jnp.asarray(vol), 0.6)
        tx = j_opt(jo)
        jstate = j_state(js, tx)
        jstep = j_step(jset, jo, tx, max_sh_degree=1, donate=False)
        for i in range(n_steps):
            jstate, _ = jstep(jstate, jnp.asarray(cams[i]), jnp.asarray(targets[i]),
                              box, C, DT, jnp.asarray(vol))
        ref = {n: np.asarray(getattr(jstate.scene, n)) for n in PARAM_NAMES}
        j_steps = int(jstate.step)

    optim = OptimizationParams(regularization=True)
    state = create_train_state(scene_from_numpy(d, "cpu").to(dtype), optim)
    step = make_train_step(tset, optim, max_sh_degree=1)
    for i in range(n_steps):
        aux = step(state, torch.as_tensor(cams[i]), torch.as_tensor(targets[i]),
                   tm.volume_box_points(vol, 0.6, device="cpu"), C, DT, torch.as_tensor(vol))
        assert np.isfinite(float(aux.loss)) and not bool(aux.overflow)
    assert state.step == j_steps == 1 + n_steps
    for name in PARAM_NAMES:
        got = getattr(state.scene, name).detach().numpy()
        assert got.dtype == ref[name].dtype
        assert np.abs(ref[name] - d[name]).max() > 0 or name == "sh_rest", name
        np.testing.assert_allclose(got, ref[name], rtol=0, atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(state.scene.alive.numpy(), d["alive"])


def test_gaussian_pdf_matches_jax():
    from nlos_gaussian_renderer_tpu.ops.render import gaussian_pdf as j_pdf
    from nlos_gaussian_renderer_tpu_torch.ops.render import gaussian_pdf

    js, ts = both(scene_np(16, 8))
    pts = (VOL + np.random.default_rng(1).uniform(-0.3, 0.3, (50, 3))).astype(np.float32)
    jset = JSettings(num_sampling_points=8, start=60, end=140, scaling_modifier=1.3)
    tset = RenderSettings(num_sampling_points=8, start=60, end=140, scaling_modifier=1.3)
    ref = np.asarray(j_pdf(js, jnp.asarray(pts), jset))
    with torch.no_grad():
        got = gaussian_pdf(ts, torch.as_tensor(pts), tset).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6)


def test_mse_loss_matches_jax():
    rng = np.random.default_rng(2)
    p, q = rng.random(80).astype(np.float32), rng.random(80).astype(np.float32)
    got = mse_loss(torch.as_tensor(p), torch.as_tensor(q))
    ref = j_mse(jnp.asarray(p), jnp.asarray(q))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6)
