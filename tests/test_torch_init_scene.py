"""The port's `init_scene` against the JAX package's, default call
(`knn_scale_init=True`) and box heuristic, on the same numpy points.

Up to 4096 points both packages take the dense |a|^2 + |b|^2 - 2 a.b
expansion (JAX `models/scene.py:_mean_knn_dist2`). It cancels ~|p|^2 / d2,
up to ~1e3x at n = 4096 in the 0.6 m volume at 1 m, so two summation
orders of the matrix product may differ by ~4e-5 relative on the squared
distances; the bound is 1e-4 (measured on the CPU: 1.2e-7 at n = 64 and
4096, the two products summing alike) and log_scales, half the log of
them, 5e-5. Above 4096 JAX calls its native grid KNN
(`native.knn_mean_dist2`, C++) and the port the exact chunked KNN in
torch: both sum dx^2 + dy^2 + dz^2 in f32 in that order and the k smallest
in ascending order; the bound is 1e-6 relative (measured: bit for bit).
A repeated point's nearest neighbour is its twin at distance 0 (exactly in
the exact branch); one point gives NaN in the dense branch in both
packages (the mean of no neighbours) and 1e-6 in the exact one."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlos_gaussian_renderer_tpu import native
from nlos_gaussian_renderer_tpu.models import scene as jscene
from nlos_gaussian_renderer_tpu_torch.models import scene as tscene

torch.set_num_threads(1)
VOL = np.array([0.0, 1.0, 0.0], np.float32)
DENSE_RTOL = 1e-4  # squared distances, dense expansion branch
EXACT_RTOL = 1e-6  # squared distances, exact branch


def points(n, seed, dups=0):
    """n points uniform in the 0.6 m volume at 1 m; the last `dups` repeat
    earlier ones exactly."""
    rng = np.random.default_rng(seed)
    p = (VOL + rng.uniform(-0.3, 0.3, (n, 3))).astype(np.float32)
    if dups:
        p[n - dups:] = p[rng.integers(0, n - dups, dups)]
    return p


def scenes(p, **kw):
    n = p.shape[0]
    rho = np.full((n, 1), 0.5, np.float32)
    js = jscene.init_scene(p, rho, VOL - 0.3, VOL + 0.3, max_sh_degree=1, capacity=n + 3,
                           **kw)
    ts = tscene.init_scene(p, rho, VOL - 0.3, VOL + 0.3, max_sh_degree=1, capacity=n + 3,
                           device="cpu", **kw)
    return js, ts


def assert_same_scene(js, ts, log_atol):
    """Every field equal to 1e-7, log_scales to `log_atol`."""
    for name in tscene.FIELD_NAMES:
        j = np.asarray(getattr(js, name))
        t = getattr(ts, name).detach().numpy()
        assert t.shape == j.shape, name
        atol = log_atol if name == "log_scales" else 1e-7
        np.testing.assert_allclose(t, j, rtol=0, atol=atol, err_msg=name)


def rel_err(t, j):
    return float(np.max(np.abs(t - j) / np.abs(j)))


@pytest.mark.parametrize("n,dups", [(64, 0), (64, 5), (4096, 0)])
def test_default_init_matches_jax_dense_branch(n, dups):
    p = points(n, seed=n + dups, dups=dups)
    jd = np.asarray(jscene._mean_knn_dist2(jnp.asarray(p)))
    td = tscene._mean_knn_dist2(torch.as_tensor(p)).numpy()
    assert rel_err(td, jd) <= DENSE_RTOL
    if dups:  # the twin, up to the expansion's cancellation
        j1 = np.asarray(jscene._mean_knn_dist2(jnp.asarray(p), k=1))[n - dups:]
        t1 = tscene._mean_knn_dist2(torch.as_tensor(p), k=1).numpy()[n - dups:]
        assert np.all(j1 < 1e-6) and np.all(t1 < 1e-6)
    js, ts = scenes(p)
    assert_same_scene(js, ts, log_atol=0.5 * DENSE_RTOL)


@pytest.mark.parametrize("dups", [0, 7])
def test_default_init_matches_jax_native_knn_branch(dups):
    n = 5000
    p = points(n, seed=11 + dups, dups=dups)
    jd = native.knn_mean_dist2(p, k=3)
    td = tscene._knn_mean_dist2_exact(torch.as_tensor(p)).numpy()
    if dups:  # the twin, exactly
        assert not tscene._knn_mean_dist2_exact(torch.as_tensor(p), k=1)[n - dups:].any()
        assert not native.knn_mean_dist2(p, k=1)[n - dups:].any()
    np.testing.assert_allclose(td, jd, rtol=EXACT_RTOL, atol=0)
    js, ts = scenes(p)
    assert_same_scene(js, ts, log_atol=1e-6)


def test_exact_knn_chunks_and_duplicates(monkeypatch):
    """Row chunks do not change the result, and n = 1 gives the native
    library's 1e-6."""
    p = points(300, seed=5)
    p[17] = p[3]
    whole = tscene._knn_mean_dist2_exact(torch.as_tensor(p))
    monkeypatch.setattr(tscene, "_KNN_BLOCK_ELEMENTS", 7 * 300)
    chunked = tscene._knn_mean_dist2_exact(torch.as_tensor(p))
    assert torch.equal(whole, chunked)
    np.testing.assert_allclose(whole.numpy(), native.knn_mean_dist2(p, k=3), rtol=EXACT_RTOL)
    one = points(1, seed=2)
    assert tscene._knn_mean_dist2_exact(torch.as_tensor(one)).tolist() == [
        pytest.approx(1e-6)]
    np.testing.assert_array_equal(tscene._knn_mean_dist2_exact(torch.as_tensor(one)).numpy(),
                                  native.knn_mean_dist2(one, k=3))


def test_one_point_gives_nan_scales_as_jax():
    js, ts = scenes(points(1, seed=4))
    j, t = np.asarray(js.log_scales), ts.log_scales.detach().numpy()
    assert np.isnan(j[0]).all() and np.isnan(t[0]).all()
    np.testing.assert_array_equal(t[1:], j[1:])


@pytest.mark.parametrize("n", [12, 5000])
def test_box_heuristic_without_knn(n):
    js, ts = scenes(points(n, seed=1), knn_scale_init=False)
    assert_same_scene(js, ts, log_atol=1e-6)
    assert len(set(ts.log_scales.detach().numpy()[:n].ravel().tolist())) == 1
