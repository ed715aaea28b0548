"""Scene evaluation and geometry export.

Port of `nlos_gaussian_renderer_tpu/utils/export.py` (the reference's
`gaussian2volume`, `nlos_helpers.py:40-69`, which thresholds density at
spherical samples and runs open3d normal estimation + Poisson
reconstruction). Two halves:

  - on the scene's device (torch): the density sum_g pdf_g * opacity_g at
    arbitrary points (`eval_density`, chunked over points and Gaussians, so
    no (points x Gaussians) block outgrows `DENSITY_BLOCK_ELEMENTS`; each
    point chunk spatially compact with the form centred in it; its matmul
    at full f32, TF32 off, as JAX's `Precision.HIGHEST`), surface
    normals from the density's gradient (`density_gradient_normals`,
    autograd, where JAX takes `jax.grad`), the density on a regular grid
    or on one scan point's spherical shell samples, and the thresholded
    point cloud;
  - on the host (numpy copies of JAX's, bit for bit): naive surface nets
    over the density grid, the low-density vertex trim, Taubin smoothing,
    and the ASCII PLY writer (no open3d, no skimage).
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import numpy as np
import torch

from nlos_gaussian_renderer_tpu_torch.models.scene import GaussianScene
from nlos_gaussian_renderer_tpu_torch.ops import math as gmath
from nlos_gaussian_renderer_tpu_torch.ops.render import RenderSettings, weighted_pdf_sums

# Points a chunk of `eval_density` and `density_gradient_normals` (each
# chunk spatially compact and centred), and the (points x Gaussians)
# elements of one block of the sum: 1 GB of float32 a temporary.
DENSITY_POINT_CHUNK = 1024
DENSITY_BLOCK_ELEMENTS = 1 << 28
MORTON_BITS = 10


@contextlib.contextmanager
def _full_f32():
    """f32 matmuls at full precision on the card (no TF32) inside the block."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _on_scene(scene: GaussianScene, x) -> torch.Tensor:
    """Host data or a tensor on the scene's device, in its float dtype."""
    x = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.array(x))
    return x.to(device=scene.means.device, dtype=scene.means.dtype)


def _points(scene: GaussianScene, points) -> torch.Tensor:
    """(A, 3) points on the scene's device in its float dtype."""
    return _on_scene(scene, points).reshape(-1, 3)


def _morton_order(pts: torch.Tensor) -> torch.Tensor:
    """Indices that sort the points by the Morton code of their cell on a
    2^MORTON_BITS grid over their bounding box: runs of the order are
    spatially compact."""
    lo = pts.amin(0)
    span = torch.clamp(pts.amax(0) - lo, min=1e-30)
    top = (1 << MORTON_BITS) - 1
    cell = torch.clamp(((pts - lo) / span * top).long(), 0, top)
    code = torch.zeros(pts.shape[0], dtype=torch.long, device=pts.device)
    for bit in range(MORTON_BITS):
        for a in range(3):
            code |= ((cell[:, a] >> bit) & 1) << (3 * bit + a)
    return torch.argsort(code)


def _centred_chunks(pts: torch.Tensor, chunk: int):
    """(indices, points - centre, centre) for chunks of at most `chunk`
    points in Morton order; a chunk's centre is the middle of its bounding
    box."""
    order = _morton_order(pts) if pts.shape[0] > chunk else None
    for i in range(0, pts.shape[0], chunk):
        idx = slice(i, i + chunk) if order is None else order[i:i + chunk]
        p = pts[idx]
        centre = (p.amin(0) + p.amax(0)) / 2
        yield idx, p - centre, centre


def _centred_forms(scene: GaussianScene, scaling_modifier: float = 1.0):
    """A function centre -> (N, 10) quadratic-form rows of the scene with
    the origin at `centre`: `gaussian_quadratic_form(means - centre, ...)`
    bit for bit, its six second-order entries (which do not move with the
    origin) computed once and the linear and constant terms per centre."""
    with torch.no_grad():
        means = scene.means.detach()
        q = gmath.gaussian_quadratic_form(torch.zeros_like(means),
                                          scene.scales * scaling_modifier, scene.rotations)
    a01, a02, a12 = q[:, 3] / 2, q[:, 4] / 2, q[:, 5] / 2
    a = ((q[:, 0], a01, a02), (a01, q[:, 1], a12), (a02, a12, q[:, 2]))

    def at(centre):
        mu = [means[:, i] - centre[i] for i in range(3)]
        amu = [a[i][0] * mu[0] + a[i][1] * mu[1] + a[i][2] * mu[2] for i in range(3)]
        muamu = amu[0] * mu[0] + amu[1] * mu[1] + amu[2] * mu[2]
        return torch.cat([q[:, :6], torch.stack([-2.0 * amu[0], -2.0 * amu[1],
                                                 -2.0 * amu[2], muamu], dim=-1)], dim=-1)

    return at


@torch.no_grad()
def eval_density(
    scene: GaussianScene,
    points,
    settings: Optional[RenderSettings] = None,
    chunk: int = DENSITY_POINT_CHUNK,
) -> np.ndarray:
    """Aggregate density sum_g pdf_g * opacity_g at (A, 3) points (numpy or
    a tensor), computed on the scene's device in its dtype; returns (A,)
    numpy.

    Matches the density returned by `estimate_rho_w(out_separately=True)`
    (`gaussian_model.py:313, 341-344`) in aggregate form; dead slots weigh 0
    (`alive` is folded into `scene.opacities`). The points go in spatially
    compact chunks (`_centred_chunks`), and each chunk evaluates the
    quadratic form with the origin at its centre: the form's terms then
    cancel from (chunk extent / sigma)^2 rather than (1 m / sigma)^2, which
    at millimetre Gaussians is what keeps the f32 result near the float64
    one (JAX evaluates it uncentred).
    """
    if settings is None:
        settings = RenderSettings(num_sampling_points=1, start=0, end=1)
    pts = _points(scene, points)
    op = scene.opacities  # (N, 1)
    forms = _centred_forms(scene, settings.scaling_modifier)
    out = torch.empty(pts.shape[0], dtype=pts.dtype, device=pts.device)
    with _full_f32():
        for idx, p, centre in _centred_chunks(pts, chunk):
            g_chunk = max(1, DENSITY_BLOCK_ELEMENTS // max(p.shape[0], 1))
            gfeat = forms(centre)
            out[idx] = weighted_pdf_sums(gmath.point_monomials(p), gfeat, op, g_chunk)[:, 0]
    return out.cpu().numpy()


def density_gradient_normals(scene: GaussianScene, points,
                             chunk: int = DENSITY_POINT_CHUNK) -> np.ndarray:
    """Unit surface normals = -grad(density)/|grad| at the given points:
    autograd of `eval_density`'s sum (centred chunks), one block of
    Gaussians at a time."""
    pts = _points(scene, points)
    with torch.no_grad():
        op = scene.opacities
        forms = _centred_forms(scene)
    grad = torch.zeros_like(pts)
    with _full_f32():
        for idx, p, centre in _centred_chunks(pts, chunk):
            g_chunk = max(1, DENSITY_BLOCK_ELEMENTS // max(p.shape[0], 1))
            with torch.no_grad():
                gfeat = forms(centre)
            g = torch.zeros_like(p)
            for k in range(0, gfeat.shape[0], g_chunk):
                pg = p.detach().requires_grad_(True)
                with torch.enable_grad():
                    m = gmath.mahalanobis_matmul(gmath.point_monomials(pg),
                                                 gfeat[k:k + g_chunk])
                    dens = torch.exp(-0.5 * m) @ op[k:k + g_chunk]
                    g += torch.autograd.grad(dens.sum(), pg)[0]
            grad[idx] = g
    g = grad.cpu().numpy()
    n = -g / np.maximum(np.linalg.norm(g, axis=-1, keepdims=True), 1e-12)
    return n.astype(np.float32)


def density_grid(
    scene: GaussianScene,
    volume_position,
    volume_size: float,
    resolution: int = 128,
) -> Tuple[np.ndarray, np.ndarray]:
    """Density on a regular grid over the hidden volume.

    Returns:
      (grid (R, R, R) densities, axes (R,) per-axis coordinates offsets).
    """
    vol_pos = np.asarray(volume_position, dtype=np.float32)
    axis = np.linspace(-volume_size / 2, volume_size / 2, resolution).astype(
        np.float32
    )
    pts = np.stack(np.meshgrid(axis, axis, axis, indexing="ij"), -1).reshape(-1, 3)
    d = eval_density(scene, pts + vol_pos)
    return d.reshape(resolution, resolution, resolution), axis + 0.0


def gaussian2volume_spherical(
    scene: GaussianScene,
    camera_pos,
    box_points,
    num_sampling_points: int,
    start: int,
    end: int,
    c: float,
    delta_t: float,
    threshold: Optional[float] = None,
):
    """Reference-parity volume query: density at the spherical shell samples
    of one (center) scan point, thresholded at the mean density
    (`gaussian2volume`, `nlos_helpers.py:40-57`). `camera_pos` and
    `box_points` go to the scene's device.

    Returns:
      (dense_points (K, 3), densities (A,), sample_points (A, 3)).
    """
    from nlos_gaussian_renderer_tpu_torch.ops.sampling import shell_grid

    grid = shell_grid(
        _on_scene(scene, camera_pos), _on_scene(scene, box_points),
        num_sampling_points, start, end, c, delta_t,
    )
    pts = grid.points.reshape(-1, 3).cpu().numpy()
    dens = eval_density(scene, pts)
    thr = float(dens.mean()) if threshold is None else threshold
    return pts[dens > thr], dens, pts


def extract_point_cloud(
    scene: GaussianScene,
    volume_position,
    volume_size: float,
    resolution: int = 96,
    threshold: Optional[float] = None,
    with_normals: bool = True,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Density-thresholded point cloud (reference `mode='mesh'` front half:
    `nlos_helpers.py:50-57`, threshold = mean density)."""
    grid, axis = density_grid(scene, volume_position, volume_size, resolution)
    thr = float(grid.mean()) if threshold is None else threshold
    idx = np.argwhere(grid > thr)
    pts = np.asarray(volume_position)[None, :] + axis[idx]
    pts = pts.astype(np.float32)
    normals = density_gradient_normals(scene, pts) if with_normals else None
    return pts, normals


def surface_nets_mesh(
    grid: np.ndarray, axis: np.ndarray, origin, threshold: float
) -> Tuple[np.ndarray, np.ndarray]:
    """Naive surface nets: one vertex per surface-crossing cell, quads (as two
    triangles) across every sign-changing face.

    Args:
      grid: (R, R, R) scalar field; axis: (R,) coordinates; origin: (3,).
    Returns:
      (vertices (V, 3), triangles (T, 3) int32).
    """
    occ = grid > threshold
    r = grid.shape[0]
    # Cells are dual to voxels: cell (i,j,k) spans voxels [i:i+2, j:j+2, k:k+2].
    corners = np.zeros((r - 1, r - 1, r - 1, 8), dtype=bool)
    ci = 0
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                corners[..., ci] = occ[
                    dx : r - 1 + dx, dy : r - 1 + dy, dz : r - 1 + dz
                ]
                ci += 1
    n_in = corners.sum(-1)
    surface = (n_in > 0) & (n_in < 8)
    cell_idx = -np.ones((r - 1, r - 1, r - 1), dtype=np.int64)
    sx, sy, sz = np.nonzero(surface)
    cell_idx[sx, sy, sz] = np.arange(len(sx))
    h = axis[1] - axis[0] if len(axis) > 1 else 1.0
    verts = np.stack(
        [axis[sx] + 0.5 * h, axis[sy] + 0.5 * h, axis[sz] + 0.5 * h], axis=-1
    ) + np.asarray(origin)[None, :]

    tris = []
    # Surface-nets vertex placement: accumulate the isosurface crossing
    # points of each cell's edges; the vertex is their centroid (falls back
    # to the cell center when a cell has in/out corners but no axis-aligned
    # crossing edge touches it). This hugs the true isosurface instead of
    # snapping to the dual-grid centers.
    v_acc = np.zeros((len(sx), 3), dtype=np.float64)
    v_cnt = np.zeros(len(sx), dtype=np.int64)
    # For each axis, faces between voxel pairs that cross the isosurface emit
    # a quad connecting the 4 surrounding surface cells.
    for ax in range(3):
        sl_lo = [slice(0, r - 1)] * 3
        sl_hi = [slice(0, r - 1)] * 3
        sl_hi[ax] = slice(1, r)
        cross = occ[tuple(sl_lo)] != occ[tuple(sl_hi)]  # (edges along ax)
        ex, ey, ez = np.nonzero(cross)
        # Linear-interpolated crossing position along this edge.
        g0 = grid[tuple(sl_lo)][ex, ey, ez]
        g1 = grid[tuple(sl_hi)][ex, ey, ez]
        t = np.clip((threshold - g0) / np.where(g1 != g0, g1 - g0, 1.0), 0, 1)
        e_idx = [ex, ey, ez]
        h_step = axis[1] - axis[0] if len(axis) > 1 else 1.0
        cross_pt = np.stack(
            [axis[e_idx[a]] + (t * h_step if a == ax else 0.0) for a in range(3)],
            axis=-1,
        )
        # The 4 cells sharing edge (ex,ey,ez)->(+1 along ax) vary over the two
        # other axes by -1/0.
        o1, o2 = [a for a in range(3) if a != ax]
        quads = []
        for d1 in (0, -1):
            for d2 in (0, -1):
                c = [ex, ey, ez]
                c = [cc.copy() for cc in c]
                c[o1] = c[o1] + d1
                c[o2] = c[o2] + d2
                valid = (c[0] >= 0) & (c[1] >= 0) & (c[2] >= 0) & \
                        (c[0] < r - 1) & (c[1] < r - 1) & (c[2] < r - 1)
                vid = np.full(len(ex), -1, dtype=np.int64)
                vid[valid] = cell_idx[c[0][valid], c[1][valid], c[2][valid]]
                quads.append(vid)
                good = vid >= 0
                np.add.at(v_acc, vid[good], cross_pt[good])
                np.add.at(v_cnt, vid[good], 1)
        q = np.stack(quads, axis=-1)  # (E, 4) order: (0,0),(0,-1),(-1,0),(-1,-1)
        ok = (q >= 0).all(axis=-1)
        q = q[ok]
        tris.append(np.stack([q[:, 0], q[:, 1], q[:, 3]], axis=-1))
        tris.append(np.stack([q[:, 0], q[:, 3], q[:, 2]], axis=-1))
    if tris:
        faces = np.concatenate(tris, axis=0).astype(np.int32)
    else:
        faces = np.zeros((0, 3), dtype=np.int32)
    touched = v_cnt > 0
    verts = verts.astype(np.float64)
    verts[touched] = v_acc[touched] / v_cnt[touched, None] + np.asarray(origin)
    return verts.astype(np.float32), faces


def trim_mesh_by_vertex_density(
    vertices: np.ndarray,
    faces: np.ndarray,
    densities: np.ndarray,
    quantile: float = 0.01,
) -> Tuple[np.ndarray, np.ndarray]:
    """Drop the lowest-density vertices and every face touching them.

    The reference removes Poisson-reconstruction vertices below the 1%
    support-density quantile (`nlos_helpers.py:62-67`); here the per-vertex
    confidence is the scene density at the vertex, which prunes the same
    low-support wisps from the iso-mesh.
    """
    if len(vertices) == 0:
        return vertices, faces
    thr = np.quantile(densities, quantile)
    keep = densities >= thr
    remap = -np.ones(len(vertices), dtype=np.int64)
    remap[keep] = np.arange(int(keep.sum()))
    fkeep = keep[faces].all(axis=1) if len(faces) else np.zeros(0, bool)
    new_faces = remap[faces[fkeep]].astype(np.int32)
    return vertices[keep], new_faces


def taubin_smooth(
    vertices: np.ndarray,
    faces: np.ndarray,
    iterations: int = 10,
    lam: float = 0.5,
    mu: float = -0.53,
) -> np.ndarray:
    """Taubin lambda/mu mesh smoothing (shrink-free Laplacian).

    The smoothing role of the reference's Poisson reconstruction (which
    inherently low-passes the surface); alternating positive/negative
    umbrella steps smooths without the volume loss of plain Laplacian.
    """
    if len(faces) == 0 or len(vertices) == 0:
        return vertices
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    e = np.unique(np.sort(e, axis=1), axis=0)
    v = vertices.astype(np.float64).copy()
    deg = np.zeros(len(v))
    np.add.at(deg, e[:, 0], 1.0)
    np.add.at(deg, e[:, 1], 1.0)
    has = deg > 0
    for _ in range(iterations):
        for f in (lam, mu):
            acc = np.zeros_like(v)
            np.add.at(acc, e[:, 0], v[e[:, 1]])
            np.add.at(acc, e[:, 1], v[e[:, 0]])
            avg = acc[has] / deg[has, None]
            v[has] += f * (avg - v[has])
    return v.astype(np.float32)


def gaussian_to_mesh(
    scene: GaussianScene,
    volume_position,
    volume_size: float,
    resolution: int = 96,
    threshold: Optional[float] = None,
    trim_quantile: Optional[float] = 0.01,
    smooth_iters: int = 10,
) -> Tuple[np.ndarray, np.ndarray]:
    """Density grid -> surface-nets mesh, post-processed for parity with the
    reference's Poisson pipeline (`gaussian2volume` mode='mesh',
    `nlos_helpers.py:50-69`): crossing-point vertex placement, low-density
    vertex trim (their 1% Poisson-density quantile), Taubin smoothing (their
    Poisson low-pass). Pass trim_quantile=None / smooth_iters=0 for the raw
    iso-surface."""
    grid, axis = density_grid(scene, volume_position, volume_size, resolution)
    thr = float(grid.mean()) if threshold is None else threshold
    verts, faces = surface_nets_mesh(
        grid, axis, np.asarray(volume_position), thr
    )
    if trim_quantile is not None and len(verts):
        dens = eval_density(scene, verts)
        verts, faces = trim_mesh_by_vertex_density(
            verts, faces, dens, trim_quantile
        )
    if smooth_iters > 0:
        verts = taubin_smooth(verts, faces, iterations=smooth_iters)
    return verts, faces


def write_ply(
    path: str,
    vertices: np.ndarray,
    faces: Optional[np.ndarray] = None,
    normals: Optional[np.ndarray] = None,
) -> None:
    """ASCII PLY writer for point clouds and triangle meshes."""
    v = np.asarray(vertices, dtype=np.float32)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\ncomment tpu-nlos-gaussians export\n")
        f.write(f"element vertex {len(v)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if normals is not None:
            f.write("property float nx\nproperty float ny\nproperty float nz\n")
        if faces is not None:
            f.write(f"element face {len(faces)}\n")
            f.write("property list uchar int vertex_indices\n")
        f.write("end_header\n")
        if normals is not None:
            rows = np.concatenate([v, np.asarray(normals, np.float32)], axis=-1)
        else:
            rows = v
        for row in rows:
            f.write(" ".join(f"{x:.6g}" for x in row) + "\n")
        if faces is not None:
            for tri in np.asarray(faces):
                f.write("3 " + " ".join(str(int(i)) for i in tri) + "\n")
