"""PyTorch port vs the JAX package: space carving (`utils/carving.py`).

JAX votes in native C++ (`csrc/nlos_native.cpp`); the port votes with torch
on the device (here the CPU), spelling the test in the C++'s order of f32
operations. Tolerance 0 throughout: first bounces, votes, feasible sets and
carved init points (both samplers, from one numpy generator) equal JAX's.
Data: JAX's `tests/test_utils.py` synthetic set (6x6 scan, 64 bins)."""

import numpy as np
import pytest
import torch

from nlos_gaussian_renderer_tpu import native as jnative
from nlos_gaussian_renderer_tpu.data.synthetic import make_synthetic_dataset
from nlos_gaussian_renderer_tpu.utils import carving as jcarving
from nlos_gaussian_renderer_tpu_torch.data.zaragoza import NLOSData
from nlos_gaussian_renderer_tpu_torch.utils.carving import (
    carved_init_points,
    carving_inputs,
    carving_votes,
    detect_first_bounces,
    space_carving,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def datasets():
    jd = make_synthetic_dataset(seed=3, scan_m=6, scan_n=6, num_bins=64, num_gt_gaussians=6,
                                num_sampling_points=8)
    return jd, NLOSData(**vars(jd))


def votes_on(coords, cams, radii, **kw):
    return carving_votes(torch.as_tensor(coords), torch.as_tensor(cams),
                         torch.as_tensor(radii), **kw).numpy()


class TestFirstBounce:
    def test_simple_rise(self):
        t = np.zeros((10, 2, 2), np.float32)
        t[4, 0, 0] = 1.0  # rises at bin 4
        t[7, 1, 1] = 0.5
        fb = detect_first_bounces(t, threshold=1e-5)
        assert fb[0, 0] == 4
        assert fb[1, 1] == 7
        assert fb[0, 1] == 0  # all-zero pixel

    def test_threshold_respected(self):
        t = np.zeros((10, 1, 1), np.float32)
        t[3, 0, 0] = 1e-6  # below threshold -> skip
        t[6, 0, 0] = 1.0
        assert detect_first_bounces(t, threshold=1e-5)[0, 0] == 6

    def test_reference_loop_parity_and_jax(self, datasets):
        transient = datasets[1].nlos_data
        bins, h, w = transient.shape
        expected = np.zeros((h, w))
        for y in range(h):
            for x in range(w):
                if np.sum(transient[:, y, x]) != 0:
                    for b in range(1, bins):
                        if transient[b, y, x] - transient[b - 1, y, x] > 1e-5:
                            expected[y, x] = b
                            break
        got = detect_first_bounces(transient, threshold=1e-5)
        np.testing.assert_array_equal(got, expected)
        want = jcarving.detect_first_bounces(transient, threshold=1e-5)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


class TestSpaceCarving:
    def test_feasible_region_near_scene(self, datasets):
        data = datasets[1]
        feasible = space_carving(data, carving_volume_size=16, ratio=0.95, device="cpu")
        assert feasible.shape[1] == 3
        vmin = data.volume_position - data.volume_size / 2 - 1e-4
        vmax = data.volume_position + data.volume_size / 2 + 1e-4
        assert (feasible >= vmin).all() and (feasible <= vmax).all()
        assert len(feasible) < 16**3

    def test_carved_init_points(self, datasets):
        pts, rho = carved_init_points(datasets[1], np.random.default_rng(0), 100,
                                      carving_volume_size=16, ratio=0.95, device="cpu")
        assert pts.shape == (100, 3) and rho.shape == (100, 1)
        assert np.isfinite(pts).all()

    def test_exact_mesh_sampling_runs(self, datasets):
        pts, rho = carved_init_points(datasets[1], np.random.default_rng(0), 100,
                                      carving_volume_size=16, ratio=0.95,
                                      exact_mesh_sampling=True, device="cpu")
        assert pts.shape == (100, 3) and np.isfinite(pts).all()

    def test_needs_a_device_or_the_card(self, datasets):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the default device is valid here")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            space_carving(datasets[1], carving_volume_size=8)


@pytest.mark.parametrize("size,ratio", [(16, 0.95), (24, 0.99), (20, 0.5)])
def test_feasible_set_equals_jax(datasets, size, ratio):
    jd, td = datasets
    want = jcarving.space_carving(jd, size, ratio)
    got = space_carving(td, size, ratio, device="cpu")
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("exact", [False, True])
def test_carved_init_points_equal_jax(datasets, exact):
    jd, td = datasets
    want = jcarving.carved_init_points(jd, np.random.default_rng(11), 300, 16, ratio=0.95,
                                       exact_mesh_sampling=exact)
    got = carved_init_points(td, np.random.default_rng(11), 300, 16, ratio=0.95,
                             exact_mesh_sampling=exact, device="cpu")
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_votes_equal_the_native_voter_on_the_dataset(datasets):
    coords, cams, radii = carving_inputs(datasets[1], 16)
    want = jnative.space_carving_votes(coords, cams, radii)
    np.testing.assert_array_equal(votes_on(coords, cams, radii), want)
    # Blocks of any size give the same counts.
    np.testing.assert_array_equal(votes_on(coords, cams, radii, block=37), want)


def test_votes_on_sphere_boundaries_round_as_the_cpp_does():
    """Radii set to the f32 distance of a voxel from each scan point: the
    test d2 >= r*r then hinges on the last bit of d2, which depends on the
    order of the f32 operations (on these pairs, 24 votes change when the
    sum is spelled dx*dx + (dy*dy + dz*dz), 80 in float64)."""
    rng = np.random.default_rng(5)
    coords = rng.uniform(-0.3, 0.3, (4000, 3)).astype(np.float32)
    cams = rng.uniform(-0.5, 0.5, (300, 3)).astype(np.float32)
    cams[:, 1] = -1.0
    pick = rng.integers(0, len(coords), len(cams))
    radii = np.linalg.norm((coords[pick] - cams).astype(np.float64), axis=1).astype(np.float32)
    radii[::7] = 0.0  # no first bounce: no vote
    radii[1::7] = -1.0
    want = jnative.space_carving_votes(coords, cams, radii)
    got = votes_on(coords, cams, radii, block=4096)
    np.testing.assert_array_equal(got, want)
    # The same order spelled in numpy.
    sep = np.zeros(len(coords), np.int32)
    for j in np.nonzero(radii > 0)[0]:
        d = coords - cams[j]
        sep += ((d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
                >= radii[j] * radii[j])
    np.testing.assert_array_equal(got, sep)


def test_no_first_bounce_anywhere_keeps_every_voxel(datasets):
    jd, td = datasets
    import dataclasses

    dark = dataclasses.replace(td, nlos_data=np.zeros_like(td.nlos_data))
    got = space_carving(dark, 8, device="cpu")
    want = jcarving.space_carving(dataclasses.replace(jd, nlos_data=dark.nlos_data), 8)
    assert got.shape == (512, 3)
    np.testing.assert_array_equal(got, want)
