"""Gaussian initialization strategies (numpy).

A copy of the samplers of `nlos_gaussian_renderer_tpu/utils/init.py`: the
same numpy generator gives the same points, bit for bit.

- `init_rand_points`: uniform random inside the (margin-shrunk) volume box —
  reference `init_rand_points` (`gaussian_utils.py:8-32`).
- `sample_from_feasible_space_jittering`: jittered resampling from the
  space-carved feasible voxel set — reference `gaussian_utils.py:131-166`
  (the carving itself lives in `utils/carving.py`).
- `sample_from_feasible_surface`: points on the surface-nets mesh of the
  carved set (`utils/export.surface_nets_mesh`) — the reference's
  `exact_mesh_samping` branch (`gaussian_utils.py:146-154`).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def init_rand_points(
    rng: np.random.Generator,
    num: int,
    pmin: np.ndarray,
    pmax: np.ndarray,
    margin: float = 0.1,
    rho_scale: float = 0.1,
) -> Tuple[np.ndarray, np.ndarray]:
    """Uniform points in the margin-shrunk volume box + uniform albedos.

    Matches reference semantics: bounds shrink by |bound|*margin on each side,
    rho ~ U[0, rho_scale).
    """
    pmin = np.asarray(pmin, dtype=np.float32)[:3]
    pmax = np.asarray(pmax, dtype=np.float32)[:3]
    rho = rng.random((num, 1), dtype=np.float32) * rho_scale
    lo = pmin + np.abs(pmin * margin)
    hi = pmax - np.abs(pmax * margin)
    samples = rng.random((num, 3), dtype=np.float32) * (hi - lo) + lo
    return samples.astype(np.float32), rho


def sample_from_feasible_surface(
    rng: np.random.Generator,
    num: int,
    feasible_points: np.ndarray,
    pmin: np.ndarray,
    pmax: np.ndarray,
    carving_volume_size: int,
    rho_scale: float = 0.1,
) -> Tuple[np.ndarray, np.ndarray]:
    """Mesh the carved voxel set and sample points ON its surface.

    Equivalent of the reference's `exact_mesh_samping` branch
    (`gaussian_utils.py:146-154`: open3d Poisson reconstruction + trimesh
    surface sampling) built on this repo's own meshing: the feasible voxels
    become a binary occupancy grid, surface-nets extracts the boundary mesh
    (`utils/export.surface_nets_mesh`), and init points are drawn
    area-weighted + barycentric-uniform over its triangles. Falls back to
    voxel jittering when the carved set is too sparse to mesh.
    """
    from nlos_gaussian_renderer_tpu_torch.utils.export import surface_nets_mesh

    pmin = np.asarray(pmin, dtype=np.float32)[:3]
    pmax = np.asarray(pmax, dtype=np.float32)[:3]
    rho = rng.random((num, 1), dtype=np.float32) * rho_scale

    s = int(carving_volume_size)
    # Rasterize the feasible centers back onto the carving lattice. The
    # carved points live at volume_position + linspace(-size/2, size/2, s)
    # per axis (utils/carving.space_carving), i.e. exactly the (pmin, pmax)
    # lattice.
    ax0 = np.linspace(pmin[0], pmax[0], s, dtype=np.float32)
    step = (pmax - pmin) / max(s - 1, 1)
    ijk = np.round(
        (feasible_points - pmin[None, :]) / np.maximum(step[None, :], 1e-12)
    ).astype(np.int64)
    inside = np.all((ijk >= 0) & (ijk < s), axis=1)
    ijk = ijk[inside]
    occ = np.zeros((s, s, s), dtype=np.float32)
    occ[ijk[:, 0], ijk[:, 1], ijk[:, 2]] = 1.0

    # surface_nets_mesh assumes one shared axis spacing; mesh in the
    # x-spacing frame and rescale y/z afterwards for anisotropic volumes.
    verts, faces = surface_nets_mesh(
        occ, ax0 - ax0[0], origin=pmin, threshold=0.5
    )
    if len(faces) == 0:
        return sample_from_feasible_space_jittering(
            rng, num, feasible_points, pmin, pmax, carving_volume_size,
            rho_scale=rho_scale,
        )
    # Undo the uniform-axis assumption: x-axis spacing was used for all
    # three axes; rescale y/z displacements from pmin accordingly.
    sx = step[0] if step[0] > 0 else 1.0
    scale = np.array([1.0, step[1] / sx, step[2] / sx], dtype=np.float32)
    verts = (verts - pmin[None, :]) * scale[None, :] + pmin[None, :]

    tri = verts[faces]  # (T, 3, 3)
    area = 0.5 * np.linalg.norm(
        np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=1
    )
    total = area.sum()
    if not np.isfinite(total) or total <= 0:
        return sample_from_feasible_space_jittering(
            rng, num, feasible_points, pmin, pmax, carving_volume_size,
            rho_scale=rho_scale,
        )
    t_idx = rng.choice(len(faces), size=num, p=area / total)
    # Uniform barycentric coordinates via the sqrt trick.
    r1 = np.sqrt(rng.random(num, dtype=np.float32))
    r2 = rng.random(num, dtype=np.float32)
    w0, w1, w2 = 1.0 - r1, r1 * (1.0 - r2), r1 * r2
    t = tri[t_idx]
    samples = (
        w0[:, None] * t[:, 0] + w1[:, None] * t[:, 1] + w2[:, None] * t[:, 2]
    )
    return samples.astype(np.float32), rho


def sample_from_feasible_space_jittering(
    rng: np.random.Generator,
    num: int,
    feasible_points: np.ndarray,
    pmin: np.ndarray,
    pmax: np.ndarray,
    carving_volume_size: int,
    rho_scale: float = 0.1,
) -> Tuple[np.ndarray, np.ndarray]:
    """Resample carved voxel centers with +-half-voxel jitter.

    Matches reference `sample_from_feasible_space_jittering`
    (`gaussian_utils.py:156-166`): half_spacing = (pmax-pmin)/(S-1)/2 per axis.
    """
    pmin = np.asarray(pmin, dtype=np.float32)[:3]
    pmax = np.asarray(pmax, dtype=np.float32)[:3]
    rho = rng.random((num, 1), dtype=np.float32) * rho_scale
    half_spacing = (pmax - pmin) / (carving_volume_size - 1) / 2.0
    base = feasible_points[rng.integers(0, len(feasible_points), size=num)]
    jitter = (rng.random((num, 3), dtype=np.float32) - 0.5) * 2.0 * half_spacing
    return (base + jitter).astype(np.float32), rho
