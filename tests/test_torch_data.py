"""PyTorch port vs the JAX package: the data layer `fit` reads.

The Zaragoza loader and writer (`data/zaragoza.py`) on the committed
`examples/data/zaragoza64_bunny.mat`, field by field and exactly; the init
samplers (`utils/init.py`, the surface sampler on the port's surface nets)
from one numpy generator, exactly; and
`make_synthetic_dataset` at JAX's tiny training size (4x4 scan, 64 bins, 8
GT Gaussians, ns 8): every field exact except the rendered transients,
rel_l2 <= 1e-4 (the two packages' f32 renders differ in summation order)."""

import dataclasses
import os

import numpy as np
import pytest

from nlos_gaussian_renderer_tpu.data import synthetic as jsyn
from nlos_gaussian_renderer_tpu.data import zaragoza as jz
from nlos_gaussian_renderer_tpu.utils import init as jinit
from nlos_gaussian_renderer_tpu_torch.data import synthetic as tsyn
from nlos_gaussian_renderer_tpu_torch.data import zaragoza as tz
from nlos_gaussian_renderer_tpu_torch.utils import init as tinit

ARTIFACT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "examples", "data", "zaragoza64_bunny.mat")
FIELDS = [f.name for f in dataclasses.fields(tz.NLOSData)]
TINY = dict(seed=0, scan_m=4, scan_n=4, num_bins=64, num_gt_gaussians=8,
            num_sampling_points=8)


def assert_same_data(a, b, skip=()):
    assert [f.name for f in dataclasses.fields(a)] == FIELDS
    for name in FIELDS:
        if name in skip:
            continue
        x, y = getattr(a, name), getattr(b, name)
        if isinstance(y, np.ndarray):
            assert isinstance(x, np.ndarray) and x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y, err_msg=name)
        else:
            assert type(x) is type(y) and x == y, name


@pytest.fixture(scope="module")
def artifact():
    return jz.load_zaragoza256_data(ARTIFACT), tz.load_zaragoza256_data(ARTIFACT)


def test_loader_matches_jax_on_the_zaragoza_artifact(artifact):
    jd, td = artifact
    assert_same_data(td, jd)
    assert td.shape == jd.shape == (256, 64, 64)
    assert len(td.astuple()) == 9
    for x, y in zip(td.astuple(), jd.astuple()):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_save_then_load_in_the_port_and_in_jax(artifact, tmp_path):
    _, td = artifact
    path = str(tmp_path / "port.mat")
    tz.save_zaragoza_mat(path, td)
    assert_same_data(tz.load_zaragoza256_data(path), td)
    assert_same_data(jz.load_zaragoza256_data(path), td)


def test_loader_key_aliases_and_missing_keys():
    mat = {"nlos_data": 1, "lightspeed": 2}
    assert tz._get(mat, "data") == 1 and tz._get(mat, "c") == 2
    assert tz._get({}, "c", np.array(1.0)) == 1.0
    with pytest.raises(KeyError):
        tz._get({}, "deltaT")


@pytest.mark.parametrize("num", [1, 100])
def test_init_rand_points_matches_jax(num):
    pmin, pmax = np.array([-0.3, 0.7, -0.3]), np.array([0.3, 1.3, 0.3])
    for margin in (0.0, 0.1):
        want = jinit.init_rand_points(np.random.default_rng(3), num, pmin, pmax, margin)
        got = tinit.init_rand_points(np.random.default_rng(3), num, pmin, pmax, margin)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.float32
            np.testing.assert_array_equal(g, w)


def test_feasible_space_jittering_matches_jax():
    rng = np.random.default_rng(4)
    feasible = rng.uniform(-0.3, 0.3, (57, 3)).astype(np.float32)
    pmin, pmax = np.full(3, -0.3), np.full(3, 0.3)
    want = jinit.sample_from_feasible_space_jittering(
        np.random.default_rng(8), 200, feasible, pmin, pmax, 64)
    got = tinit.sample_from_feasible_space_jittering(
        np.random.default_rng(8), 200, feasible, pmin, pmax, 64)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def _ball(s=24, radius=0.3):
    """A solid-ball feasible set centred at the origin in [-0.5, 0.5]^3."""
    ax = np.linspace(-0.5, 0.5, s, dtype=np.float32)
    g = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3)
    return g[np.linalg.norm(g, axis=1) <= radius], s, radius


def test_surface_vs_jitter_distribution_and_jax():
    """JAX's TestSurfaceSampling.test_surface_vs_jitter_distribution on the
    port, and the port's surface samples equal JAX's from one generator."""
    feasible, s, radius = _ball()
    pmin, pmax = np.full(3, -0.5, np.float32), np.full(3, 0.5, np.float32)
    surf, rho = tinit.sample_from_feasible_surface(np.random.default_rng(1), 800, feasible,
                                                   pmin, pmax, s)
    want = jinit.sample_from_feasible_surface(np.random.default_rng(1), 800, feasible, pmin,
                                              pmax, s)
    for g, w in zip((surf, rho), want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    jit, _ = tinit.sample_from_feasible_space_jittering(np.random.default_rng(1), 800, feasible,
                                                        pmin, pmax, s)
    r_surf = np.linalg.norm(surf, axis=1)
    r_jit = np.linalg.norm(jit, axis=1)
    voxel = 1.0 / (s - 1)
    assert abs(np.median(r_surf) - radius) < 1.5 * voxel
    assert np.std(r_surf) < 2 * voxel
    assert np.std(r_jit) > 3 * np.std(r_surf)
    assert (r_jit < radius - 2 * voxel).mean() > 0.15


def test_sparse_set_falls_back_as_jax():
    """One feasible voxel: the surface sampler falls back to jittering,
    and returns JAX's points from one generator."""
    pmin, pmax = np.full(3, -0.5, np.float32), np.full(3, 0.5, np.float32)
    one = np.zeros((1, 3), np.float32)
    pts, rho = tinit.sample_from_feasible_surface(np.random.default_rng(0), 50, one, pmin,
                                                  pmax, 8)
    assert pts.shape == (50, 3) and np.isfinite(pts).all()
    want = jinit.sample_from_feasible_surface(np.random.default_rng(0), 50, one, pmin, pmax, 8)
    np.testing.assert_array_equal(pts, want[0])
    np.testing.assert_array_equal(rho, want[1])


def test_synthetic_dataset_matches_jax():
    jd, jscene = jsyn.make_synthetic_dataset(**TINY, return_scene=True)
    td, tscene = tsyn.make_synthetic_dataset(**TINY, return_scene=True, device="cpu")
    assert_same_data(td, jd, skip=("nlos_data",))
    a, b = td.nlos_data.astype(np.float64), jd.nlos_data.astype(np.float64)
    assert td.nlos_data.dtype == np.float32 and a.shape == b.shape == (64, 4, 4)
    rel = float(np.linalg.norm(a - b) / np.linalg.norm(b))
    print(f"make_synthetic_dataset nlos_data rel_l2 vs JAX: {rel:.3e}")
    assert rel <= 1e-4, rel
    for name in ("means", "log_scales", "logit_opacities", "sh_dc", "alive"):
        np.testing.assert_allclose(getattr(tscene, name).detach().numpy(),
                                   np.asarray(getattr(jscene, name)), rtol=1e-6, err_msg=name)


def test_synthetic_dataset_defaults_to_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsyn.make_synthetic_dataset(**TINY)
