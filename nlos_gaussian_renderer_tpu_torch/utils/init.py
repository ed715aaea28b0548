"""Gaussian initialization strategies (numpy).

A copy of the samplers of `nlos_gaussian_renderer_tpu/utils/init.py`: the
same numpy generator gives the same points, bit for bit.

- `init_rand_points`: uniform random inside the (margin-shrunk) volume box —
  reference `init_rand_points` (`gaussian_utils.py:8-32`).
- `sample_from_feasible_space_jittering`: jittered resampling from the
  space-carved feasible voxel set — reference `gaussian_utils.py:131-166`.
- `sample_from_feasible_surface` needs the surface-nets mesher of
  `utils/export.py`, which is not ported yet (ROADMAP.md Queue 1 item 6):
  it raises.
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
    """Points on the meshed carved surface: not ported yet."""
    raise NotImplementedError(
        "sample_from_feasible_surface needs utils/export.surface_nets_mesh, "
        "which is not ported yet (ROADMAP.md Queue 1 item 6)"
    )


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
