"""PyTorch port vs the JAX package: MCMC densification (`models/densify.py`),
the counter-based draws (`ops/random.py`) and the SGLD position noise
(`train.sgld_position_noise`), on the CPU.

The counterparts of JAX's `tests/test_densify.py` and of the SGLD tests of
`tests/test_train.py`. The states are JAX's (`make_state`: uniform points
in [-1, 1]^3, SH degree 1), carried across as numpy arrays. JAX draws its
donors by `jax.random.categorical` and its noise by `jax.random.normal`;
the port draws the same distributions from `ops/random.py`, so the parity
tests inject JAX's own draws. Tolerances: the relocation rule rel 1e-5;
`densify_step` with JAX's draws: copied rows and `alive` exactly, every
field and both Adam moments rel 1e-5, zeroed moment rows exactly 0; the
SGLD noise from JAX's normals atol 1e-7 at |noise| <= 1 (4e-7 with random
rotations: `quat_to_rotmat`'s own f32 gap); the sampler's frequencies over 2e5 draws within 0.01.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlos_gaussian_renderer_tpu.configs.default import OptimizationParams as JOptim
from nlos_gaussian_renderer_tpu.models import densify as jdensify
from nlos_gaussian_renderer_tpu.models.scene import init_scene as j_init_scene
from nlos_gaussian_renderer_tpu.ops import math as jmath
from nlos_gaussian_renderer_tpu.train import make_optimizer as j_make_optimizer
from nlos_gaussian_renderer_tpu.train import sgld_position_noise as j_sgld
from nlos_gaussian_renderer_tpu_torch import train as ttrain
from nlos_gaussian_renderer_tpu_torch.configs.default import OptimizationParams
from nlos_gaussian_renderer_tpu_torch.models import densify as tdensify
from nlos_gaussian_renderer_tpu_torch.models.scene import FIELD_NAMES, scene_from_numpy
from nlos_gaussian_renderer_tpu_torch.ops import math as tmath
from nlos_gaussian_renderer_tpu_torch.ops import random as prng

torch.set_num_threads(1)
GROUPS = ttrain.GROUPS


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def make_state(n=16, capacity=32, seed=0):
    """JAX's `tests/test_densify.py:make_state`: (scene, tx, opt_state)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    rho = rng.uniform(0.2, 0.8, (n, 1)).astype(np.float32)
    scene = j_init_scene(pts, rho, [-1] * 3, [1] * 3, max_sh_degree=1, capacity=capacity)
    tx = j_make_optimizer(JOptim())
    return scene, tx, tx.init(scene)


def jax_moments(opt_state):
    """{group: (mu, nu)} numpy arrays of an optax state of `make_optimizer`."""
    inner = opt_state.inner_states
    out = {}
    for g in GROUPS:
        adam = inner[g].inner_state[0]
        f = ttrain.GROUP_FIELD[g]
        out[g] = (np.asarray(getattr(adam.mu, f)), np.asarray(getattr(adam.nu, f)))
    return out


def port_state(jscene, jopt):
    """The port's (scene, AdamState) from a JAX scene and optax state."""
    scene = scene_from_numpy(jscene, "cpu")
    mom = jax_moments(jopt)
    opt = ttrain.AdamState(tx=ttrain.make_optimizer(OptimizationParams()),
                           mu=[torch.as_tensor(mom[g][0].copy()) for g in GROUPS],
                           nu=[torch.as_tensor(mom[g][1].copy()) for g in GROUPS],
                           count=torch.zeros((), dtype=torch.int32))
    return scene, opt


def port_make_state(n=16, capacity=32, seed=0):
    jscene, _, jopt = make_state(n, capacity, seed)
    return port_state(jscene, jopt)


def step_tensor(v):
    return torch.tensor(v, dtype=torch.int32)


# --- the relocation rule -------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 5, 20, 51, 91])
def test_compute_relocation_matches_jax(n):
    rng = np.random.default_rng(n)
    op = rng.uniform(0.005, 0.999, 64).astype(np.float32)
    sc = rng.uniform(0.001, 0.2, (64, 3)).astype(np.float32)
    counts = np.full(64, n, np.int32)
    jo, js = jdensify.compute_relocation(jnp.asarray(op), jnp.asarray(sc), jnp.asarray(counts))
    to, ts = tdensify.compute_relocation(torch.as_tensor(op), torch.as_tensor(sc),
                                         torch.as_tensor(counts))
    assert to.dtype == ts.dtype == torch.float32
    assert rel(to.numpy(), jo) <= 1e-5 and rel(ts.numpy(), js) <= 1e-5, (
        rel(to.numpy(), jo), rel(ts.numpy(), js))


def test_relocation_tables_equal_jax():
    np.testing.assert_array_equal(tdensify._relocation_tables(), jdensify._S_TABLE)
    assert tdensify.MAX_SPLIT == jdensify.MAX_SPLIT


def test_relocation_n1_identity():
    o = torch.tensor([0.3, 0.9])
    s = torch.ones((2, 3)) * 0.1
    o2, s2 = tdensify.compute_relocation(o, s, torch.tensor([1, 1]))
    np.testing.assert_allclose(o2.numpy(), o.numpy(), rtol=1e-5)
    np.testing.assert_allclose(s2.numpy(), s.numpy(), rtol=1e-4)


def test_relocation_conserves_opacity():
    o = torch.tensor([0.5, 0.8, 0.99])
    n = torch.tensor([2, 5, 20])
    o2, _ = tdensify.compute_relocation(o, torch.ones((3, 3)), n)
    np.testing.assert_allclose(1 - (1 - o2.numpy()) ** n.numpy(), o.numpy(), rtol=1e-4)


def test_relocation_scale_shrinks_with_n():
    _, s2 = tdensify.compute_relocation(torch.full((4,), 0.9), torch.ones((4, 3)),
                                        torch.tensor([1, 2, 5, 10]))
    norms = s2.numpy()[:, 0]
    assert np.all(np.diff(norms) < 0)
    np.testing.assert_allclose(norms[0], 1.0, rtol=1e-4)


def test_relocation_clamped_to_max_split():
    a = tdensify.compute_relocation(torch.tensor([0.5]), torch.ones((1, 3)),
                                    torch.tensor([tdensify.MAX_SPLIT]))
    b = tdensify.compute_relocation(torch.tensor([0.5]), torch.ones((1, 3)),
                                    torch.tensor([tdensify.MAX_SPLIT + 40]))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# --- densify_step against JAX's, with JAX's draws ------------------------------------


def _dying_state(case):
    """A JAX (scene, opt_state) with nonzero moments and dead-opacity rows:
    'all16' 16 of 32 alive, rows 0-3 dying; 'alive20' slots 0-19 of 32
    alive, rows 2, 5, 11 dying; 'grow64' 64 of 128 alive, rows 0-5 dying."""
    n, cap, dying, alive = {
        "all16": (16, 32, [0, 1, 2, 3], None),
        "alive20": (20, 32, [2, 5, 11], 20),
        "grow64": (64, 128, [0, 1, 2, 3, 4, 5], None),
    }[case]
    scene, _, opt = make_state(n=n, capacity=cap)
    rng = np.random.default_rng(7)
    lo = scene.logit_opacities + jnp.asarray(
        rng.uniform(-0.5, 0.5, scene.logit_opacities.shape).astype(np.float32))
    lo = lo.at[np.asarray(dying)].set(jmath.inverse_sigmoid(0.001))
    scene = dataclasses.replace(scene, logit_opacities=lo)
    if alive is not None:
        scene = dataclasses.replace(scene, alive=jnp.zeros(cap).at[:alive].set(1.0))
    opt = jax.tree.map(
        lambda l: jnp.asarray(np.abs(rng.normal(size=l.shape)).astype(np.float32))
        if hasattr(l, "shape") and l.ndim >= 1 and l.shape[0] == cap else l, opt)
    return scene, opt, cap


@pytest.mark.parametrize("case", ["all16", "alive20", "grow64"])
def test_densify_step_matches_jax_with_its_draws(case):
    jscene, jopt, cap = _dying_state(case)
    key = jax.random.PRNGKey(11)
    k1, k2 = jax.random.split(key)
    seen = {}

    def draw(probs, which):
        p = jnp.asarray(probs.numpy())
        idx = jax.random.categorical((k1, k2)[which], jnp.log(jnp.maximum(p, 1e-30)),
                                     shape=(cap,))
        seen[which] = np.asarray(idx)
        return torch.as_tensor(np.asarray(idx).astype(np.int64))

    js2, jo2 = jdensify.densify_step(jscene, jopt, key, cap_max=cap)
    scene, opt = port_state(jscene, jopt)
    ptrs = [t.data_ptr() for t in [getattr(scene, n) for n in FIELD_NAMES] + opt.mu + opt.nu]
    tdensify.densify_step(scene, opt, 0, step_tensor(1), cap, draw=draw)
    assert ptrs == [t.data_ptr() for t in [getattr(scene, n) for n in FIELD_NAMES]
                    + opt.mu + opt.nu], "densify_step must write in place"
    assert set(seen) == {0, 1}

    before = {n: np.asarray(getattr(jscene, n)) for n in FIELD_NAMES}
    got = {n: getattr(scene, n).detach().numpy() for n in FIELD_NAMES}
    want = {n: np.asarray(getattr(js2, n)) for n in FIELD_NAMES}
    np.testing.assert_array_equal(got["alive"], want["alive"])
    # Rows written from a donor: copied fields exactly equal.
    written = np.any(before["means"] != want["means"], axis=1)
    assert written.any() or case == "all16"
    for n in ("means", "quats", "sh_dc", "sh_rest"):
        np.testing.assert_array_equal(got[n][written], want[n][written], err_msg=n)
    for n in FIELD_NAMES:
        assert rel(got[n], want[n]) <= 1e-5, (n, rel(got[n], want[n]))
    jm = jax_moments(jo2)
    for i, g in enumerate(GROUPS):
        assert rel(opt.mu[i].numpy(), jm[g][0]) <= 1e-5, g
        assert rel(opt.nu[i].numpy(), jm[g][1]) <= 1e-5, g
    # The zeroed rows: JAX's zero rows are the port's, and exactly 0.
    zero = np.all(jm["mu"][0] == 0, axis=1)
    assert zero.any()
    for t in opt.mu + opt.nu:
        assert np.all(t.numpy()[zero] == 0.0)


def test_densify_growth_to_cap():
    scene, opt = port_make_state(n=16, capacity=32)
    tdensify.densify_step(scene, opt, 0, step_tensor(1), cap_max=32)
    assert float(scene.num_alive) == 16  # int(1.05 * 16) = 16: no growth
    scene, opt = port_make_state(n=16, capacity=32)
    with torch.no_grad():
        scene.alive.zero_()
        scene.alive[:20] = 1.0
    tdensify.densify_step(scene, opt, 0, step_tensor(1), cap_max=32)
    assert float(scene.num_alive) == 21  # int(1.05 * 20) = 21


def test_densify_growth_is_jax_f32_rule():
    """f32(1.05) * f32(n) truncated, as JAX's: 50,000 -> 52,499 -> 55,123
    -> 57,879 -> 60,772 -> 63,810 (a Python product gives 52,500 first)."""
    n, seq = 50_000, []
    for _ in range(5):
        nt = torch.tensor(float(n), dtype=torch.float32)
        n = int((nt * torch.full_like(nt, 1.05)).to(torch.int32))
        want = int(np.asarray((1.05 * jnp.asarray(float(seq[-1] if seq else 50_000),
                                                   jnp.float32)).astype(jnp.int32)))
        assert n == want
        seq.append(n)
    assert seq == [52_499, 55_123, 57_879, 60_772, 63_810]
    # densify_step grows by that rule: 200 alive of 256 -> 209 (not 210).
    scene, opt = port_make_state(n=200, capacity=256)
    tdensify.densify_step(scene, opt, 3, step_tensor(4), cap_max=256)
    assert int(scene.num_alive) == int(np.float32(1.05) * np.float32(200)) == 209


def test_densify_relocates_dead_onto_donors():
    scene, opt = port_make_state(n=16, capacity=16)
    with torch.no_grad():
        scene.logit_opacities[:8] = float(tmath.inverse_sigmoid(torch.tensor(0.001)))
    donors = scene.means[8:].detach().clone().numpy()
    tdensify.densify_step(scene, opt, 1, step_tensor(2), cap_max=16)
    for r in scene.means[:8].detach().numpy():
        assert np.min(np.linalg.norm(donors - r[None], axis=1)) < 1e-6
    alive = scene.alive.numpy() > 0.5
    assert float(scene.opacities.detach()[alive].min()) >= 0.005 - 1e-6


def test_densify_zeroes_moment_rows():
    scene, opt = port_make_state(n=16, capacity=32)
    for t in opt.mu + opt.nu:
        t.fill_(1.0)
    with torch.no_grad():
        scene.logit_opacities[:4] = float(tmath.inverse_sigmoid(torch.tensor(0.001)))
    tdensify.densify_step(scene, opt, 2, step_tensor(3), cap_max=32)
    for t in opt.mu + opt.nu:
        assert float(t[:4].abs().max()) == 0.0
    assert int(opt.count) == 0


def test_densify_keeps_shapes_and_storage():
    scene, opt = port_make_state(n=16, capacity=64)
    tensors = [getattr(scene, n) for n in FIELD_NAMES] + opt.mu + opt.nu
    shapes = [t.shape for t in tensors]
    ptrs = [t.data_ptr() for t in tensors]
    tdensify.densify_step(scene, opt, 3, step_tensor(4), cap_max=64)
    after = [getattr(scene, n) for n in FIELD_NAMES] + opt.mu + opt.nu
    assert [t.shape for t in after] == shapes and [t.data_ptr() for t in after] == ptrs
    assert all(isinstance(getattr(scene, n), torch.nn.Parameter) for n in FIELD_NAMES[:-1])


def test_densify_finite_after_many_steps():
    scene, opt = port_make_state(n=64, capacity=128)
    for i in range(5):
        tdensify.densify_step(scene, opt, 4, step_tensor(10 + i), cap_max=128)
    assert float(scene.num_alive) > 64
    for n in FIELD_NAMES:
        assert torch.isfinite(getattr(scene, n)).all(), n


def test_densify_step_is_a_function_of_seed_and_step():
    runs = []
    for step in (5, 5, 6):
        scene, opt = port_make_state(n=64, capacity=128, seed=2)
        with torch.no_grad():
            scene.logit_opacities[:10] = -8.0
        tdensify.densify_step(scene, opt, 9, step_tensor(step), cap_max=128)
        runs.append(scene.means.detach().clone())
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])


# --- the port's sampler --------------------------------------------------------------


def test_categorical_never_draws_a_zero_row_and_matches_probs():
    p = torch.tensor([0.0, 1.0, 2.0, 0.0, 3.0, 0.0, 4.0, 0.0])
    probs = p.repeat(25_000)  # 2e5 draws; row r of the 8 is (draw mod 8)
    idx = prng.categorical(probs, 3, step_tensor(17))
    assert idx.dtype == torch.int64 and idx.shape == (200_000,)
    assert bool((probs[idx] > 0).all())
    freq = torch.bincount(idx % 8, minlength=8).double() / idx.numel()
    np.testing.assert_allclose(freq.numpy(), (p / p.sum()).numpy(), atol=0.01)


def test_categorical_edges():
    # A uniform at the top of the CDF lands on the last positive row, never
    # past it; with no positive weight every draw is row 0.
    probs = torch.tensor([0.0, 0.5, 0.0, 0.0])
    idx = prng.categorical(probs, 0, step_tensor(1))
    assert bool((idx == 1).all())
    assert bool((prng.categorical(torch.zeros(5), 0, step_tensor(1)) == 0).all())


def test_draws_repeat_for_the_same_seed_and_step():
    probs = torch.rand(1000, generator=torch.Generator().manual_seed(0))
    a = prng.categorical(probs, 1, step_tensor(40))
    b = prng.categorical(probs, 1, step_tensor(40))
    c = prng.categorical(probs, 1, step_tensor(41))
    d = prng.categorical(probs, 2, step_tensor(40))
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, d)
    z1 = prng.normal(1, step_tensor(40), (1000, 3))
    assert torch.equal(z1, prng.normal(1, step_tensor(40), (1000, 3)))
    assert not torch.equal(z1, prng.normal(1, step_tensor(41), (1000, 3)))
    z = prng.normal(0, step_tensor(3), (100_000, 3))
    assert abs(float(z.mean())) < 0.01 and abs(float(z.std()) - 1.0) < 0.01


# --- SGLD position noise -------------------------------------------------------------


def _sgld_scene(rotated=False):
    """JAX `tests/test_train.py:382`'s scene: 32 Gaussians, half at
    dead-opacity logits (-10), half confident (+10), identity quaternions;
    `rotated`: random quaternions, so that R S eps mixes the axes."""
    rng = np.random.default_rng(0)
    scene = j_init_scene(rng.uniform(-1, 1, (32, 3)).astype(np.float32),
                         rng.uniform(0.2, 0.8, (32, 1)).astype(np.float32),
                         [-1] * 3, [1] * 3, max_sh_degree=0)
    scene = dataclasses.replace(
        scene, logit_opacities=scene.logit_opacities.at[:16].set(-10.0).at[16:].set(10.0))
    if rotated:
        scene = dataclasses.replace(
            scene, quats=jnp.asarray(rng.normal(size=(32, 4)).astype(np.float32)))
    return scene


# atol: 1e-7 on JAX's scene, where only exp(log_scales) differs (an ulp);
# 4e-7 rotated, where `quat_to_rotmat` adds its f32 gap of 3.6e-7 (measured).
@pytest.mark.parametrize("rotated,seed,step,atol", [(False, 0, 1, 1e-7),
                                                    (True, 3, 250, 4e-7)])
def test_sgld_noise_matches_jax_with_its_normals(rotated, seed, step, atol):
    jscene = _sgld_scene(rotated)
    key = jax.random.fold_in(jax.random.PRNGKey(seed), step)
    # lr 2e-6: |noise| up to ~1 here (lr * noise_lr = 1, scales ~0.4).
    lr = 2e-6
    want = np.asarray(j_sgld(jscene, key, jnp.asarray(lr, jnp.float32),
                             JOptim(sgld_noise=True)))
    eps = np.array(jax.random.normal(key, jscene.means.shape, jscene.means.dtype))
    got = ttrain.sgld_position_noise(scene_from_numpy(jscene, "cpu"), torch.as_tensor(eps),
                                     torch.tensor(lr, dtype=torch.float32),
                                     OptimizationParams(sgld_noise=True)).detach().numpy()
    assert 0.1 < np.abs(want).max() <= 2.0
    print(f"sgld vs JAX max |diff| {np.abs(got - want).max():.3e}")
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def test_sgld_noise_shapes_and_gating():
    scene = scene_from_numpy(_sgld_scene(), "cpu")
    eps = prng.normal(0, step_tensor(1), (32, 3))
    noise = ttrain.sgld_position_noise(scene, eps, torch.tensor(1e-4),
                                       OptimizationParams(sgld_noise=True)).detach()
    assert noise.shape == (32, 3)
    low, high = float(noise[:16].abs().mean()), float(noise[16:].abs().mean())
    assert low > 100 * max(high, 1e-30)
