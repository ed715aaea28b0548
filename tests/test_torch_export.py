"""PyTorch port vs the JAX package: geometry export (`utils/export.py`).

Scenes are built by the JAX package and carried to the port
(`scene_from_numpy`), so both evaluate the same Gaussians. Tolerances: the
density (`eval_density`, `density_grid`, the spherical query) rel_l2 <=
1e-4 against JAX's f32 (uncentred quadratic form, full-f32 matmuls on both
sides; against float64 at millimetre sigmas the port's centred chunks
<= 1e-5); normals cosine >= 1 - 1e-4 where |grad| exceeds 1e-3 of its
maximum; the point clouds' sets differ only by grid points whose density
lies within 1e-4 * max(density) of the mean threshold; the numpy mesh
functions (surface nets, trim, Taubin) and `write_ply` bit for bit (the
bytes of the file) on the same inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlos_gaussian_renderer_tpu.models.scene import init_scene as j_init_scene
from nlos_gaussian_renderer_tpu.ops import math as jm
from nlos_gaussian_renderer_tpu.utils import export as jexport
from nlos_gaussian_renderer_tpu_torch.models.scene import scene_from_numpy
from nlos_gaussian_renderer_tpu_torch.ops import math as tm
from nlos_gaussian_renderer_tpu_torch.utils import export as texport

torch.set_num_threads(1)
VOL = [0, 1.0, 0]


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def both(jscene):
    return jscene, scene_from_numpy(jscene, "cpu")


def cluster(n=12, spread=0.2, seed=2, **kw):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-spread, spread, (n, 3)).astype(np.float32) + np.array(
        [0, 1.0, 0], np.float32)
    return both(j_init_scene(pts, rng.uniform(0.3, 0.8, (n, 1)).astype(np.float32),
                             [-0.3, 0.7, -0.3], [0.3, 1.3, 0.3], max_sh_degree=0, **kw))


@pytest.fixture(scope="module")
def scenes():
    return cluster()


@pytest.fixture(scope="module")
def posed():
    """A scene in a generic pose (rotations, anisotropic scales, a dead
    slot), 40 Gaussians."""
    import dataclasses

    rng = np.random.default_rng(9)
    js, _ = cluster(n=40, spread=0.15, seed=4)
    js = dataclasses.replace(
        js, quats=jnp.asarray(rng.normal(size=(40, 4)).astype(np.float32)),
        log_scales=js.log_scales + jnp.asarray(rng.uniform(-0.5, 0.5, (40, 3)), jnp.float32),
        alive=js.alive.at[3].set(0.0))
    return both(js)


class TestExport:
    def test_density_grid(self, scenes):
        grid, axis = texport.density_grid(scenes[1], VOL, 0.6, resolution=24)
        assert grid.shape == (24, 24, 24)
        assert grid.max() > grid.mean() > 0

    def test_point_cloud_and_ply(self, scenes, tmp_path):
        pts, normals = texport.extract_point_cloud(scenes[1], VOL, 0.6, resolution=24)
        assert len(pts) > 0
        np.testing.assert_allclose(np.linalg.norm(normals, axis=-1), 1.0, rtol=1e-3)
        p = str(tmp_path / "cloud.ply")
        texport.write_ply(p, pts, normals=normals)
        header = open(p).read(200)
        assert header.startswith("ply")
        assert f"element vertex {len(pts)}" in header

    def test_mesh_extraction(self, scenes, tmp_path):
        verts, faces = texport.gaussian_to_mesh(scenes[1], VOL, 0.6, resolution=24)
        assert len(verts) > 0 and len(faces) > 0
        assert faces.max() < len(verts)
        p = str(tmp_path / "mesh.ply")
        texport.write_ply(p, verts, faces=faces)
        assert f"element face {len(faces)}" in open(p).read()


class TestMeshPostProcessing:
    def _sphere_grid(self, r=32, rad=0.3):
        axis = np.linspace(-0.5, 0.5, r).astype(np.float32)
        g = np.stack(np.meshgrid(axis, axis, axis, indexing="ij"), -1)
        dist = np.linalg.norm(g, axis=-1)
        return (rad - dist).astype(np.float32), axis

    def test_vertices_hug_isosurface(self):
        grid, axis = self._sphere_grid()
        verts, faces = texport.surface_nets_mesh(grid, axis, np.zeros(3), 0.0)
        assert len(verts) > 0 and len(faces) > 0
        radii = np.linalg.norm(verts, axis=-1)
        h = axis[1] - axis[0]
        assert np.abs(radii - 0.3).max() < 0.8 * h
        assert np.abs(radii - 0.3).mean() < 0.25 * h

    def test_taubin_smooth_reduces_roughness_without_shrink(self):
        grid, axis = self._sphere_grid()
        verts, faces = texport.surface_nets_mesh(grid, axis, np.zeros(3), 0.0)
        rng = np.random.default_rng(0)
        rough = verts + rng.normal(0, 0.004, verts.shape).astype(np.float32)
        sm = texport.taubin_smooth(rough, faces, iterations=10)

        def roughness(v):
            return float(np.std(np.linalg.norm(v, axis=-1)))

        assert roughness(sm) < 0.5 * roughness(rough)
        r0 = float(np.mean(np.linalg.norm(rough, axis=-1)))
        r1 = float(np.mean(np.linalg.norm(sm, axis=-1)))
        assert abs(r1 - r0) / r0 < 0.02

    def test_quantile_trim_removes_low_density_wisp(self):
        verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [5, 5, 5], [6, 5, 5], [5, 6, 5]],
                         np.float32)
        faces = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
        dens = np.array([1.0, 1.0, 1.0, 0.01, 0.01, 0.01])
        v2, f2 = texport.trim_mesh_by_vertex_density(verts, faces, dens, quantile=0.5)
        assert len(v2) == 3 and len(f2) == 1
        np.testing.assert_array_equal(f2[0], [0, 1, 2])
        np.testing.assert_allclose(v2, verts[:3])

    def test_gaussian_to_mesh_postprocessed(self):
        _, scene = cluster(spread=0.15)
        v_raw, f_raw = texport.gaussian_to_mesh(scene, VOL, 0.6, resolution=24,
                                                trim_quantile=None, smooth_iters=0)
        v_pp, f_pp = texport.gaussian_to_mesh(scene, VOL, 0.6, resolution=24)
        assert len(v_pp) > 0 and len(f_pp) > 0
        assert f_pp.max() < len(v_pp)
        assert len(v_pp) <= len(v_raw)


class TestSphericalVolumeQuery:
    def test_reference_parity_query(self):
        rng = np.random.default_rng(5)
        vol = np.array([0, 1.0, 0], np.float32)
        pts = vol + rng.uniform(-0.15, 0.15, (10, 3)).astype(np.float32)
        js, ts = both(j_init_scene(pts, rng.uniform(0.3, 0.8, (10, 1)).astype(np.float32),
                                   vol - 0.3, vol + 0.3, max_sh_degree=0,
                                   knn_scale_init=False))
        box = tm.volume_box_points(vol, 0.6, device="cpu")
        kw = dict(num_sampling_points=8, start=60, end=140, c=1.0, delta_t=0.01)
        dense_pts, dens, sample_pts = texport.gaussian2volume_spherical(
            ts, [0.0, 0.0, 0.0], box, **kw)
        assert sample_pts.shape == (80 * 64, 3)
        assert dens.shape == (80 * 64,)
        assert 0 < len(dense_pts) < len(sample_pts)
        d_dense = np.linalg.norm(dense_pts - vol, axis=1).mean()
        d_all = np.linalg.norm(sample_pts - vol, axis=1).mean()
        assert d_dense < d_all
        _, jdens, jsample = jexport.gaussian2volume_spherical(
            js, jnp.asarray([0.0, 0.0, 0.0]), jm.volume_box_points(jnp.asarray(vol), 0.6), **kw)
        np.testing.assert_allclose(sample_pts, jsample, atol=1e-6)
        assert rel(dens, jdens) <= 1e-4


@pytest.mark.parametrize("which", ["cluster", "posed"])
def test_eval_density_and_grid_match_jax(scenes, posed, which):
    js, ts = scenes if which == "cluster" else posed
    pts = np.random.default_rng(3).uniform(-0.3, 0.3, (5000, 3)).astype(np.float32) + VOL
    got, want = texport.eval_density(ts, pts), jexport.eval_density(js, jnp.asarray(pts))
    assert got.dtype == np.float32 and got.shape == (5000,)
    assert rel(got, want) <= 1e-4, rel(got, want)
    g_grid, g_axis = texport.density_grid(ts, VOL, 0.6, resolution=20)
    w_grid, w_axis = jexport.density_grid(js, VOL, 0.6, resolution=20)
    np.testing.assert_array_equal(g_axis, w_axis)
    assert rel(g_grid, w_grid) <= 1e-4, rel(g_grid, w_grid)


def test_eval_density_chunks_over_points_and_gaussians(posed, monkeypatch):
    """Blocks of 300 (point, Gaussian) pairs and chunks of 64 points sum to
    the one-block result (f32 reassociation only), and a float64 scene
    agrees with both."""
    _, ts = posed
    pts = np.random.default_rng(4).uniform(-0.3, 0.3, (1000, 3)).astype(np.float32) + VOL
    whole = texport.eval_density(ts, pts)
    monkeypatch.setattr(texport, "DENSITY_BLOCK_ELEMENTS", 300)
    chunked = texport.eval_density(ts, pts, chunk=64)
    np.testing.assert_allclose(chunked, whole, rtol=1e-5, atol=1e-7 * whole.max())
    ts64 = scene_from_numpy({n: getattr(ts, n).detach().numpy() for n in
                             ("means", "log_scales", "quats", "logit_opacities", "sh_dc",
                              "sh_rest", "alive")}, "cpu")
    ts64 = ts64.double()
    d64 = texport.eval_density(ts64, pts)
    assert d64.dtype == np.float64
    assert rel(whole, d64) <= 1e-5


def test_centred_forms_equal_the_form_at_the_shifted_means(posed):
    """Each chunk's forms: `gaussian_quadratic_form(means - centre)` bit for
    bit, the second-order entries computed once."""
    _, ts = posed
    for centre in ([0.1, 0.95, -0.2], [0.0, 1.0, 0.0], [-0.3, 1.3, 0.25]):
        c = torch.tensor(centre)
        got = texport._centred_forms(ts, 1.3)(c)
        want = tm.gaussian_quadratic_form(ts.means.detach() - c, ts.scales.detach() * 1.3,
                                          ts.rotations.detach())
        assert torch.equal(got, want)


def test_centred_chunks_keep_millimetre_gaussians_near_float64():
    """3,000 Gaussians of sigma 3-6 mm about 1 m from the origin: the
    uncentred f32 form (JAX's) cancels terms ~(1 m / 4 mm)^2 and lands
    ~1e-3 off float64 (rel_l2); centred per chunk of points the port's f32
    density stays within 1e-5 of it (measured 1.4e-6 and 1.0e-3)."""
    from nlos_gaussian_renderer_tpu_torch.ops.render import weighted_pdf_sums

    rng = np.random.default_rng(8)
    n = 3000
    d = {"means": (np.array([0, 1.0, 0]) + rng.uniform(-0.05, 0.05, (n, 3))).astype(np.float32),
         "log_scales": np.log(rng.uniform(0.003, 0.006, (n, 3))).astype(np.float32),
         "quats": rng.normal(size=(n, 4)).astype(np.float32),
         "logit_opacities": rng.normal(size=(n, 1)).astype(np.float32),
         "sh_dc": np.zeros((n, 1), np.float32), "sh_rest": np.zeros((n, 0), np.float32),
         "alive": np.ones(n, np.float32)}
    ts = scene_from_numpy(d, "cpu")
    ax = np.linspace(-0.06, 0.06, 20).astype(np.float32)
    pts = (np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3)
           + np.array([0, 1.0, 0], np.float32))
    ref = texport.eval_density(scene_from_numpy(d, "cpu").double(), pts)
    centred = rel(texport.eval_density(ts, pts), ref)
    with torch.no_grad():
        unc = weighted_pdf_sums(tm.point_monomials(torch.as_tensor(pts)), ts.quadratic_form(),
                                ts.opacities)[:, 0].numpy()
    uncentred = rel(unc, ref)
    print(f"rel_l2 vs float64: centred {centred:.3e}, uncentred {uncentred:.3e}")
    assert centred <= 1e-5
    assert uncentred > 10 * centred


def test_dead_slots_add_no_density(posed):
    import dataclasses

    js, ts = posed
    pts = np.asarray(js.means[3:4])  # the dead Gaussian's own centre
    alive_only = dataclasses.replace(
        js, **{f: getattr(js, f)[np.arange(40) != 3] for f in
               ("means", "log_scales", "quats", "logit_opacities", "sh_dc", "sh_rest",
                "alive")})
    got = texport.eval_density(ts, pts)
    want = texport.eval_density(scene_from_numpy(alive_only, "cpu"), pts)
    # 40 terms against 39: the same sum up to f32 reassociation.
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("which", ["cluster", "posed"])
def test_normals_match_jax(scenes, posed, which):
    js, ts = scenes if which == "cluster" else posed
    pts = (np.random.default_rng(6).uniform(-0.25, 0.25, (2000, 3)) + VOL).astype(np.float32)
    got = texport.density_gradient_normals(ts, pts, chunk=512)
    want = jexport.density_gradient_normals(js, jnp.asarray(pts))
    assert got.dtype == np.float32 and got.shape == (2000, 3)
    # Where the gradient is not negligible (its norm from the port's own
    # autograd at the same points).
    p = torch.tensor(pts, requires_grad=True)
    dens = (torch.exp(-0.5 * tm.mahalanobis_matmul(tm.point_monomials(p),
                                                    ts.quadratic_form().detach()))
            @ ts.opacities.detach()).sum()
    gnorm = torch.autograd.grad(dens, p)[0].norm(dim=-1).numpy()
    big = gnorm > 1e-3 * gnorm.max()
    cos = np.sum(got[big] * want[big], axis=-1)
    assert big.mean() > 0.5 and cos.min() >= 1 - 1e-4, (big.mean(), cos.min())


def test_point_cloud_sets_differ_only_at_the_threshold(posed):
    js, ts = posed
    g_pts, g_n = texport.extract_point_cloud(ts, VOL, 0.6, resolution=28)
    w_pts, w_n = jexport.extract_point_cloud(js, VOL, 0.6, resolution=28)
    grid, axis = jexport.density_grid(js, VOL, 0.6, resolution=28)
    thr, tol = float(grid.mean()), 1e-4 * float(grid.max())
    g_set = {tuple(p) for p in g_pts.tolist()}
    w_set = {tuple(p) for p in w_pts.tolist()}
    odd = np.asarray(sorted(g_set ^ w_set), np.float32).reshape(-1, 3)
    assert len(g_set & w_set) > 0.99 * len(w_set)
    if len(odd):
        ijk = np.rint((odd - np.asarray(VOL, np.float32) - axis[0]) / (axis[1] - axis[0]))
        d = grid[tuple(ijk.astype(int).T)]
        assert np.all(np.abs(d - thr) <= tol), (d, thr)
    common = [i for i, p in enumerate(g_pts.tolist()) if tuple(p) in w_set]
    w_index = {tuple(p): i for i, p in enumerate(w_pts.tolist())}
    wn = w_n[[w_index[tuple(g_pts[i].tolist())] for i in common]]
    cos = np.sum(g_n[common] * wn, axis=-1)
    assert np.median(cos) >= 1 - 1e-4


def _mesh_inputs(seed=0, r=20):
    rng = np.random.default_rng(seed)
    axis = np.linspace(-0.5, 0.5, r).astype(np.float32)
    g = np.stack(np.meshgrid(axis, axis, axis, indexing="ij"), -1)
    grid = (0.3 - np.linalg.norm(g, axis=-1)
            + 0.05 * rng.normal(size=(r, r, r))).astype(np.float32)
    return grid, axis


def test_mesh_functions_and_ply_bytes_equal_jax(tmp_path):
    grid, axis = _mesh_inputs()
    origin = np.array([0.0, 1.0, 0.0], np.float32)
    v, f = texport.surface_nets_mesh(grid, axis, origin, 0.0)
    jv, jf = jexport.surface_nets_mesh(grid, axis, origin, 0.0)
    for a, b in ((v, jv), (f, jf)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    dens = np.random.default_rng(1).random(len(v))
    tv, tf_ = texport.trim_mesh_by_vertex_density(v, f, dens, 0.2)
    jtv, jtf = jexport.trim_mesh_by_vertex_density(jv, jf, dens, 0.2)
    np.testing.assert_array_equal(tv, jtv)
    np.testing.assert_array_equal(tf_, jtf)
    sm = texport.taubin_smooth(tv, tf_, iterations=5)
    np.testing.assert_array_equal(sm, jexport.taubin_smooth(jtv, jtf, iterations=5))
    normals = np.random.default_rng(2).normal(size=sm.shape).astype(np.float32)
    for kw in (dict(faces=tf_), dict(normals=normals), {}):
        texport.write_ply(str(tmp_path / "t.ply"), sm, **kw)
        jexport.write_ply(str(tmp_path / "j.ply"), sm, **kw)
        assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
