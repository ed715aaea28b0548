"""Space-carving initialization.

Port of `nlos_gaussian_renderer_tpu/utils/carving.py` (the reference's
nlos-neus-derived carving, `gaussian_model/gaussian_utils.py:38-129`):
  1. detect the first-bounce time bin per scan pixel (first finite-difference
     rise above a threshold; numpy, a copy of JAX's),
  2. vote: a carving-grid voxel is "outside" for a scan point if it is
     farther than that scan point's first-bounce radius; voxels outside for
     (almost) every scan point are feasible surface candidates,
  3. jittered (or surface) resampling of feasible voxels into Gaussian init
     points (`utils/init.py`).

JAX votes in native C++ (`csrc/nlos_native.cpp`, `space_carving_votes`);
here the vote is torch on the device (`carving_votes`), chunked over voxels
and scan points into int32 counts. It spells the test as the C++ does,
`(dx*dx + dy*dy) + dz*dz >= r*r`, one rounded f32 operation at a time (no
fused multiply-add), so a voxel on a sphere's boundary votes as in JAX and
the feasible set is exactly JAX's.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from nlos_gaussian_renderer_tpu_torch.data.zaragoza import NLOSData
from nlos_gaussian_renderer_tpu_torch.ops import math as gmath

# Elements of one (voxels, scan points) block of the vote: 64 MB a float32
# temporary on the card, 4 MB on the CPU (a block that stays in cache there;
# the vote is ten times slower at the card's block size).
VOTE_BLOCK_ELEMENTS = {"cuda": 1 << 24, "cpu": 1 << 20}


def detect_first_bounces(transient: np.ndarray, threshold: float = 1e-5) -> np.ndarray:
    """First bin where the histogram rises by > threshold, per scan pixel.

    Matches reference semantics (`gaussian_utils.py:38-50`): scans b from 1;
    returns 0 for pixels with an all-zero histogram or no rise.

    Args:
      transient: (L, M, N).
    Returns:
      (M, N) float bin indices.
    """
    diff = np.diff(transient, axis=0) > threshold  # (L-1, M, N)
    any_rise = diff.any(axis=0)
    first = diff.argmax(axis=0) + 1  # bin index of transient[b] - transient[b-1]
    nonzero = transient.sum(axis=0) != 0
    return np.where(any_rise & nonzero, first, 0).astype(np.float32)


@torch.no_grad()
def carving_votes(coords, cams, radii, block: Optional[int] = None) -> torch.Tensor:
    """votes[v] = #scan points whose first-bounce sphere excludes voxel v
    (squared distance >= radius^2), int32, on the inputs' device.

    coords (V, 3), cams (C, 3), radii (C,) float32 tensors on one device;
    scan points with radius <= 0 have no first bounce and cast no vote.
    Blocks of at most `block` (voxel, scan point) pairs (by default
    `VOTE_BLOCK_ELEMENTS` of the device): (V, C) is never materialised.
    Each block squares and adds in place, one f32 rounding an operation:
    ((dx*dx + dy*dy) + dz*dz) >= r*r, as the C++ voter."""
    if block is None:
        block = VOTE_BLOCK_ELEMENTS.get(coords.device.type, VOTE_BLOCK_ELEMENTS["cuda"])
    keep = radii > 0
    cams, r = cams[keep], radii[keep]
    r2 = r * r
    votes = torch.zeros(coords.shape[0], dtype=torch.int32, device=coords.device)
    n_c = cams.shape[0]
    if n_c == 0:
        return votes
    c_chunk = max(1, min(n_c, block // max(coords.shape[0], 1)))
    v_chunk = max(1, block // c_chunk)
    for j in range(0, n_c, c_chunk):
        cx, cy, cz = (cams[j:j + c_chunk, a] for a in range(3))
        r2_j = r2[j:j + c_chunk]
        for i in range(0, coords.shape[0], v_chunk):
            v = coords[i:i + v_chunk]
            d2 = v[:, 0:1] - cx
            d2.mul_(d2)
            t = v[:, 1:2] - cy
            t.mul_(t)
            d2.add_(t)
            torch.sub(v[:, 2:3], cz, out=t)
            t.mul_(t)
            d2.add_(t)
            votes[i:i + v_chunk] += torch.sum(d2 >= r2_j, dim=1, dtype=torch.int32)
    return votes


def carving_inputs(data: NLOSData, carving_volume_size: int, start: int = 0,
                   threshold: float = 1e-5):
    """(coords (s^3, 3) voxel centres relative to the volume centre,
    cams (MN, 3) scan points relative to it, radii (MN,) first-bounce
    radii): float32 numpy, computed as JAX computes them."""
    vol_pos = np.asarray(data.volume_position, dtype=np.float32)
    vol_size = float(data.volume_size)
    cams = np.asarray(data.camera_grid_positions, dtype=np.float32)  # (3, MN)
    cams_shifted = cams - vol_pos[:, None]

    radii = detect_first_bounces(data.nlos_data[start:], threshold) + start
    radii = (radii * data.c * data.deltaT).reshape(-1)  # (MN,)

    s = carving_volume_size
    axis = np.linspace(-vol_size / 2, vol_size / 2, s, dtype=np.float32)
    coords = np.stack(np.meshgrid(axis, axis, axis, indexing="ij"), -1).reshape(-1, 3)
    return (coords, np.ascontiguousarray(cams_shifted.T, dtype=np.float32),
            radii.astype(np.float32))


def space_carving(
    data: NLOSData,
    carving_volume_size: int,
    ratio: float = 0.99,
    start: int = 0,
    threshold: float = 1e-5,
    device=None,
) -> np.ndarray:
    """Carve the hidden volume; return feasible voxel centers (world space).

    Matches `space_carving` (`gaussian_utils.py:53-129`): voxels farther than
    the first-bounce sphere of a scan point get that point's vote; voxels with
    votes > ratio * max_votes survive. The vote runs on `device` (by default
    the CUDA card).

    Returns:
      (K, 3) feasible voxel centers (K >= 1; falls back to the volume center
      when carving eliminates everything).
    """
    vol_pos = np.asarray(data.volume_position, dtype=np.float32)
    coords, cams, radii = carving_inputs(data, carving_volume_size, start, threshold)
    if not np.any(radii > 0):
        return (coords + vol_pos).astype(np.float32)

    dev = gmath.default_device(device)
    votes = carving_votes(torch.as_tensor(coords, device=dev),
                          torch.as_tensor(cams, device=dev),
                          torch.as_tensor(radii, device=dev))
    return feasible_from_votes(coords, votes.cpu().numpy(), ratio, vol_pos)


def feasible_from_votes(coords: np.ndarray, votes: np.ndarray, ratio: float,
                        volume_position) -> np.ndarray:
    """World-space centres of the voxels with votes > ratio * max votes
    (the volume centre when none is left)."""
    votes = np.asarray(votes).astype(np.int64)
    vote_threshold = votes.max() * ratio
    feasible = coords[votes > vote_threshold]
    if len(feasible) == 0:
        feasible = np.zeros((1, 3), dtype=np.float32)
    return (feasible + np.asarray(volume_position, np.float32)).astype(np.float32)


def carved_init_points(
    data: NLOSData,
    rng: np.random.Generator,
    num: int,
    carving_volume_size: int,
    ratio: float = 0.99,
    rho_scale: float = 0.1,
    exact_mesh_sampling: bool = False,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Space-carving + resampling init (reference
    `sample_from_feasible_space_jittering`, `gaussian_utils.py:131-166`).

    `exact_mesh_sampling` mirrors the reference's optional branch
    (`gaussian_utils.py:146-154`): mesh the carved set and sample ON the
    surface instead of jittering voxel centers (surface nets replaces the
    open3d Poisson reconstruction). The vote runs on `device`; the sampling
    is numpy, from `rng`."""
    from nlos_gaussian_renderer_tpu_torch.utils.init import (
        sample_from_feasible_space_jittering,
        sample_from_feasible_surface,
    )

    feasible = space_carving(data, carving_volume_size, ratio, device=device)
    pmin = data.volume_position - data.volume_size / 2
    pmax = data.volume_position + data.volume_size / 2
    sampler = (
        sample_from_feasible_surface if exact_mesh_sampling
        else sample_from_feasible_space_jittering
    )
    return sampler(
        rng, num, feasible, pmin, pmax, carving_volume_size, rho_scale=rho_scale
    )
