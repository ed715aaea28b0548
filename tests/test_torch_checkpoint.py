"""PyTorch port vs the JAX package: checkpoints (`utils/checkpoint.py`).

The port writes `step_{N}/state.npz` (JAX writes orbax checkpoints, which
need JAX). Tolerance 0 throughout: a JAX state saved and restored by orbax,
carried through `train_state_from_numpy` and the port's save / restore,
equals the JAX state exactly (SH degree 0, whose `sh_rest` is zero-size,
and 3); the port's own round trip is bit for bit, `alive` and both Adam
moments included; a template of another shape or dtype raises."""

import os

import jax
import numpy as np
import pytest
import torch

from nlos_gaussian_renderer_tpu.configs.default import OptimizationParams as JOptim
from nlos_gaussian_renderer_tpu.models.scene import init_scene as j_init_scene
from nlos_gaussian_renderer_tpu.train import create_train_state as j_create_state
from nlos_gaussian_renderer_tpu.train import make_optimizer as j_make_optimizer
from nlos_gaussian_renderer_tpu.utils import checkpoint as jckpt
from nlos_gaussian_renderer_tpu_torch import train as ttrain
from nlos_gaussian_renderer_tpu_torch.configs.default import OptimizationParams
from nlos_gaussian_renderer_tpu_torch.models.scene import FIELD_NAMES, init_scene
from nlos_gaussian_renderer_tpu_torch.utils.checkpoint import (
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)

torch.set_num_threads(1)
GROUPS = ttrain.GROUPS


def port_state(n=8, sh=1, seed=1, device="cpu"):
    """A port state with random parameters, alive mask, moments and
    counters (nothing left at its initial value)."""
    rng = np.random.default_rng(seed)
    scene = init_scene(rng.uniform(-1, 1, (n, 3)).astype(np.float32),
                       rng.uniform(0, 1, (n, 1)).astype(np.float32),
                       [-1] * 3, [1] * 3, max_sh_degree=sh, device=device)
    st = ttrain.create_train_state(scene, OptimizationParams())
    with torch.no_grad():
        for t in ttrain.state_tensors(st)[:-3]:
            if t.is_floating_point():
                t.copy_(torch.as_tensor(rng.normal(size=tuple(t.shape)).astype(np.float32)))
        st.scene.alive.copy_(torch.as_tensor((rng.random(n) > 0.3).astype(np.float32)))
        st.opt_state.count.fill_(17)
        st.step.fill_(18)
        st.active_sh_degree.fill_(sh)
    return st


def assert_states_equal(a, b):
    for x, y in zip(ttrain.state_tensors(a), ttrain.state_tensors(b)):
        assert x.dtype == y.dtype and x.shape == y.shape and x.device == y.device
        assert torch.equal(x, y)


def jax_state_to_numpy(st) -> dict:
    """A JAX `TrainState` in `train_state_from_numpy`'s form."""
    inner = st.opt_state.inner_states
    adam = {g: inner[g].inner_state[0] for g in GROUPS}
    field = ttrain.GROUP_FIELD
    return {
        "scene": {n: np.asarray(getattr(st.scene, n)) for n in FIELD_NAMES},
        "mu": {g: np.asarray(getattr(adam[g].mu, field[g])) for g in GROUPS},
        "nu": {g: np.asarray(getattr(adam[g].nu, field[g])) for g in GROUPS},
        "count": {g: int(adam[g].count) for g in GROUPS},
        "step": int(st.step),
        "active_sh_degree": int(st.active_sh_degree),
    }


def test_roundtrip(tmp_path):
    """JAX's TestCheckpoint.test_roundtrip on the port: save, find it as
    the latest, restore into a fresh template."""
    st = port_state()
    target = save_checkpoint(str(tmp_path / "ckpt"), st)
    assert target == os.path.join(str(tmp_path / "ckpt"), "step_18")
    assert latest_checkpoint(str(tmp_path / "ckpt")) == target
    template = ttrain.create_train_state(port_state(seed=2).scene, OptimizationParams())
    restored = restore_checkpoint(target, template)
    assert_states_equal(restored, st)
    assert restored.opt_state.tx is template.opt_state.tx
    assert set(os.listdir(target)) == {"state.npz"}


def test_npz_holds_flat_keys_and_no_pickle(tmp_path):
    target = save_checkpoint(str(tmp_path), port_state(sh=0), step=3)
    assert target.endswith("step_3")
    with np.load(os.path.join(target, "state.npz"), allow_pickle=False) as z:
        keys = set(z.files)
        assert z["scene/sh_rest"].shape == (8, 0)
        assert z["step"].dtype == np.int32 and z["step"].shape == ()
    assert keys == ({f"scene/{n}" for n in FIELD_NAMES} | {f"mu/{g}" for g in GROUPS}
                    | {f"nu/{g}" for g in GROUPS} | {"count", "step", "active_sh_degree"})


@pytest.mark.parametrize("sh", [0, 3])
def test_jax_state_through_orbax_and_the_port_is_exact(tmp_path, sh):
    rng = np.random.default_rng(sh)
    scene = j_init_scene(rng.uniform(-1, 1, (10, 3)).astype(np.float32),
                         rng.uniform(0, 1, (10, 1)).astype(np.float32),
                         [-1] * 3, [1] * 3, max_sh_degree=sh)
    tx = j_make_optimizer(JOptim())
    state = j_create_state(scene, tx)
    # Random values in every float leaf: parameters, alive and both moments.
    state = jax.tree.map(
        lambda x: np.asarray(rng.normal(size=np.shape(x)), np.asarray(x).dtype)
        if np.issubdtype(np.asarray(x).dtype, np.floating) else x, state)
    jtarget = jckpt.save_checkpoint(str(tmp_path / "jax"), state, step=7)
    jstate = jckpt.restore_checkpoint(jtarget, j_create_state(scene, tx))
    want = jax_state_to_numpy(jstate)
    port = ttrain.train_state_from_numpy(want, OptimizationParams(), device="cpu")
    target = save_checkpoint(str(tmp_path / "port"), port)
    template = ttrain.create_train_state(
        init_scene(np.zeros((10, 3), np.float32), np.zeros((10, 1), np.float32),
                   [-1] * 3, [1] * 3, max_sh_degree=sh, device="cpu"), OptimizationParams())
    got = ttrain.train_state_to_numpy(restore_checkpoint(target, template))
    for part in ("scene", "mu", "nu"):
        for k, w in want[part].items():
            assert got[part][k].dtype == w.dtype and got[part][k].shape == w.shape, k
            np.testing.assert_array_equal(got[part][k], w, err_msg=f"{part}/{k}")
    assert got["count"] == want["count"]["mu"]
    assert (got["step"], got["active_sh_degree"]) == (want["step"], want["active_sh_degree"])
    if sh == 0:
        assert got["scene"]["sh_rest"].shape == (10, 0)


def test_latest_checkpoint_edge_cases(tmp_path):
    assert latest_checkpoint(str(tmp_path / "missing")) is None
    assert latest_checkpoint(str(tmp_path)) is None
    for name in ("step_9", "step_10", "step_x", "step_", "other_99", "step_2.5"):
        (tmp_path / name).mkdir()
    assert latest_checkpoint(str(tmp_path)) == os.path.join(str(tmp_path), "step_10")
    # JAX's answer on the same directory.
    assert jckpt.latest_checkpoint(str(tmp_path)) == latest_checkpoint(str(tmp_path))


def test_save_replaces_a_checkpoint_of_the_same_step(tmp_path):
    a, b = port_state(seed=1), port_state(seed=5)
    save_checkpoint(str(tmp_path), a, step=4)
    target = save_checkpoint(str(tmp_path), b, step=4)
    template = ttrain.create_train_state(port_state().scene, OptimizationParams())
    assert_states_equal(restore_checkpoint(target, template), b)


@pytest.mark.parametrize("what", ["capacity", "sh_degree", "dtype"])
def test_template_mismatch_raises(tmp_path, what):
    target = save_checkpoint(str(tmp_path), port_state(n=8, sh=1))
    n, sh = (9, 1) if what == "capacity" else (8, 2) if what == "sh_degree" else (8, 1)
    template = port_state(n=n, sh=sh)
    if what == "dtype":
        template = ttrain.train_state_from_numpy(
            {**ttrain.train_state_to_numpy(template),
             "scene": {k: v.astype(np.float64)
                       for k, v in ttrain.train_state_to_numpy(template)["scene"].items()}},
            OptimizationParams(), device="cpu")
    with pytest.raises(ValueError, match="template"):
        restore_checkpoint(target, template)
