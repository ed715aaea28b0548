"""PyTorch port vs the JAX package: `render_transient(backend="pallas")`, its
gradients and three train steps, through the K7/K8 plain versions (CPU
tensors) against JAX's `pallas` backend with its kernels in interpret mode.

Scene: tests/test_torch_render.py's (48 Gaussians, sigma 5-14 cm), 8x8
rays, bins 60..140, TileSpec(4, 8, 16, k_max=64) (JAX's with a_sub=256,
g_tile=32), no occlusion and aggregate `netf`. Both packages evaluate the form uncentred
~1 m from the origin; at these scales the rounding of their two summation
orders (JAX's dot, the port's fixed elementwise order) stays far below the
bounds: histograms rel_l2 <= 1e-5, gradients rel_l2 <= 1e-4 per group (the
quaternions' 4e-4, the f32 floor both sides carry, see
tests/test_torch_render.py), and Adam steps max-abs <= 1e-6 after one step,
1e-5 after three."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_render import VOL, both, rel_l2, scene_np

from nlos_gaussian_renderer_tpu.configs.default import OptimizationParams as JOptim
from nlos_gaussian_renderer_tpu.ops import fused as jf
from nlos_gaussian_renderer_tpu.ops import math as jm
from nlos_gaussian_renderer_tpu.ops.render import RenderSettings as JSettings
from nlos_gaussian_renderer_tpu.ops.render import mse_loss as j_mse
from nlos_gaussian_renderer_tpu.ops.render import render_transient as j_render
from nlos_gaussian_renderer_tpu.train import create_train_state as j_state
from nlos_gaussian_renderer_tpu.train import make_optimizer as j_opt
from nlos_gaussian_renderer_tpu.train import make_train_step as j_step
from nlos_gaussian_renderer_tpu_torch.configs.default import OptimizationParams
from nlos_gaussian_renderer_tpu_torch.models.scene import PARAM_NAMES, scene_from_numpy
from nlos_gaussian_renderer_tpu_torch.ops import fused as tf
from nlos_gaussian_renderer_tpu_torch.ops import math as tm
from nlos_gaussian_renderer_tpu_torch.ops.render import (
    RenderSettings,
    mse_loss,
    render_transient,
)
from nlos_gaussian_renderer_tpu_torch.ops.fused_rsort import RSortSpec
from nlos_gaussian_renderer_tpu_torch.train import (
    OverflowGate,
    create_train_state,
    make_train_step,
    restore_state,
    snapshot_state,
)

torch.set_num_threads(1)
C, DT = 1.0, 0.01
CAM = np.array([0.05, 0.0, -0.1], np.float32)
J_BOX = jm.volume_box_points(jnp.asarray(VOL), 0.6)
T_BOX = tm.volume_box_points(VOL, 0.6, device="cpu")
SPEC_KW = dict(t_theta=4, t_phi=8, t_r=16, k_max=64)


def settings(occ):
    kw = dict(num_sampling_points=8, start=60, end=140, occlusion=occ, backend="pallas")
    return (RenderSettings(**kw, tile_spec=tf.TileSpec(**SPEC_KW)),
            JSettings(**kw, tile_spec=jf.TileSpec(**SPEC_KW, a_sub=256, g_tile=32)))


@pytest.mark.parametrize("occ", [False, True])
def test_pallas_histogram_and_grads_match_jax_pallas(occ):
    js, ts = both(scene_np(48, 3))
    tset, jset = settings(occ)
    target = np.full(80, 0.1, np.float32)

    def jloss(sc):
        _, h, ov = j_render(sc, jnp.asarray(CAM), J_BOX, C, DT, jnp.asarray(VOL), 1, jset)
        return j_mse(h, jnp.asarray(target))[0], (h, ov)

    jg, (jh, jov) = jax.grad(jloss, has_aux=True)(js)
    _, th, tov = render_transient(ts, torch.as_tensor(CAM), T_BOX, C, DT,
                                  torch.as_tensor(VOL), 1, tset)
    assert not bool(tov) and not bool(jov)
    assert rel_l2(th.detach(), jh) <= 1e-5, rel_l2(th.detach(), jh)
    mse_loss(th, torch.as_tensor(target))[0].backward()
    for name in PARAM_NAMES:
        ref = np.asarray(getattr(jg, name))
        got = getattr(ts, name).grad.numpy()
        assert np.abs(ref).max() > 0, name
        tol = 4e-4 if name == "quats" else 1e-4
        assert rel_l2(got, ref) <= tol, (name, rel_l2(got, ref))


@pytest.mark.parametrize("n_steps,atol", [(1, 1e-6), (3, 1e-5)])
def test_pallas_adam_steps_match_jax_train_step(n_steps, atol):
    """Three f32 steps carry the gradients' last-bit differences through
    Adam's normalised update (measured 2.1e-6 on log_scales; the dense test
    holds three steps in float64, which the interpret-mode Pallas kernels,
    f32 by construction, do not offer)."""
    d = scene_np(24, 5)
    rng = np.random.default_rng(9)
    cams = [np.array([[rng.uniform(-0.2, 0.2), 0.0, rng.uniform(-0.2, 0.2)]], np.float32)
            for _ in range(n_steps)]
    targets = rng.uniform(0.0, 0.2, (n_steps, 1, 80)).astype(np.float32)
    tset, jset = settings(False)

    jo = JOptim(regularization=True)
    jsc, ts = both(d)
    tx = j_opt(jo)
    jstate = j_state(jsc, tx)
    jstep = j_step(jset, jo, tx, max_sh_degree=1, donate=False)
    for i in range(n_steps):
        jstate, jaux = jstep(jstate, jnp.asarray(cams[i]), jnp.asarray(targets[i]), J_BOX,
                             C, DT, jnp.asarray(VOL))
        assert not bool(jaux.overflow)
    ref = {n: np.asarray(getattr(jstate.scene, n)) for n in PARAM_NAMES}

    optim = OptimizationParams(regularization=True)
    state = create_train_state(ts, optim)
    step = make_train_step(tset, optim, max_sh_degree=1)
    for i in range(n_steps):
        aux = step(state, torch.as_tensor(cams[i]), torch.as_tensor(targets[i]), T_BOX, C,
                   DT, torch.as_tensor(VOL))
        assert np.isfinite(float(aux.loss)) and not bool(aux.overflow)
    assert state.step == int(jstate.step) == 1 + n_steps
    for name in PARAM_NAMES:
        got = getattr(state.scene, name).detach().numpy()
        assert np.abs(ref[name] - d[name]).max() > 0 or name == "sh_rest", name
        np.testing.assert_allclose(got, ref[name], rtol=0, atol=atol, err_msg=name)


def test_pallas_train_step_raises_on_overflow_before_updating():
    """(The name predates the change.) A step whose tile list overflowed
    k_max no longer raises: as in JAX it applies the update and returns the
    overflow flag as a device bool, and the state it started from comes
    back from a snapshot, which is what `fit` replays from."""
    ts = scene_from_numpy(scene_np(48, 3), "cpu")
    tset = settings(False)[0]
    tset = tset._replace(tile_spec=tset.tile_spec._replace(k_max=4))
    optim = OptimizationParams()
    state = create_train_state(ts, optim)
    before = {n: p.detach().clone() for n, p in ts.named_parameters()}
    snap = snapshot_state(state)
    aux = make_train_step(tset, optim, max_sh_degree=1)(
        state, torch.as_tensor(CAM)[None], torch.full((1, 80), 0.05), T_BOX, C, DT,
        torch.as_tensor(VOL))
    assert isinstance(aux.overflow, torch.Tensor) and aux.overflow.dtype == torch.bool
    assert bool(aux.overflow)
    assert state.step == 2 and not torch.equal(ts.means, before["means"])
    restore_state(state, snap)
    for n, p in ts.named_parameters():
        assert torch.equal(p, before[n]), n
    assert state.step == 1 and int(state.opt_state.count) == 0


@pytest.mark.parametrize("backend", ["pallas", "pallas_rsort"])
def test_gated_train_step_refits_and_replays(backend):
    """Capacities too small for the step's camera: `fit`'s overflow gate
    (`OverflowGate.run_gated`) finds the step's device flag set, restores
    the state it started from, re-fits the capacities on the probe scan
    points plus that step's camera and replays the step, which then equals
    a step built with the re-fitted settings."""
    d = scene_np(48, 3)
    tset = settings(False)[0]._replace(
        backend=backend, tile_spec=tf.TileSpec(**dict(SPEC_KW, k_max=4)),
        rsort_spec=RSortSpec(t_theta=4, t_phi=8, t_chunk=8, g_tile=32, w_max=4,
                             max_groups=1))
    optim = OptimizationParams()
    args = (torch.as_tensor(CAM)[None], torch.full((1, 80), 0.05), T_BOX, C, DT,
            torch.as_tensor(VOL))
    probes = np.zeros((1, 3), np.float32)

    state = create_train_state(scene_from_numpy(d, "cpu"), optim)
    gate = OverflowGate(tset, optim, 1, probes, T_BOX, C, DT)
    aux = gate.run_gated(False, state, *args, what="the test step")
    assert gate.retunes == 1 and state.step == 2 and not bool(aux.overflow)
    assert not gate.overflow_detected
    if backend == "pallas":
        assert gate.settings.tile_spec.k_max > 4
    else:
        assert gate.settings.rsort_spec.w_max > 4

    ref_state = create_train_state(scene_from_numpy(d, "cpu"), optim)
    make_train_step(gate.settings, optim, 1)(ref_state, *args)
    for name in PARAM_NAMES:
        got = getattr(state.scene, name).detach()
        assert torch.equal(got, getattr(ref_state.scene, name).detach()), name
        assert name == "sh_rest" or not np.array_equal(got.numpy(), d[name]), name