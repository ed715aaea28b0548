"""Synthetic confocal NLOS scenes (numpy-seeded).

Port of the scene half of `nlos_gaussian_renderer_tpu/data/synthetic.py`:
the same numpy draws give the same scene in both packages. The visible wall
is the y=0 plane scanned over an (x, z) grid; the hidden volume sits at
positive y.
"""

from __future__ import annotations

import numpy as np
import torch

from nlos_gaussian_renderer_tpu_torch.models.scene import GaussianScene, init_scene
from nlos_gaussian_renderer_tpu_torch.ops import math as gmath


def make_scan_grid(m: int, n: int, grid_half_extent: float = 0.4) -> np.ndarray:
    """(3, M*N) scan positions on the y=0 wall over an (x, z) grid."""
    xs = np.linspace(-grid_half_extent, grid_half_extent, m)
    zs = np.linspace(-grid_half_extent, grid_half_extent, n)
    xx, zz = np.meshgrid(xs, zs, indexing="ij")
    pos = np.stack([xx.ravel(), np.zeros(m * n), zz.ravel()], axis=0)
    return pos.astype(np.float32)


def make_ground_truth_scene(
    rng: np.random.Generator,
    num_gaussians: int,
    volume_position: np.ndarray,
    volume_size: float,
    max_sh_degree: int = 0,
    device=None,
) -> GaussianScene:
    """A random Gaussian blob cluster inside the hidden volume, with solid
    opacities (0.8) and isotropic scales of 6% of the volume size, on
    `device` (by default the CUDA card, as `init_scene`)."""
    half = 0.3 * volume_size
    points = volume_position[None, :] + rng.uniform(
        -half, half, size=(num_gaussians, 3)
    )
    rho = rng.uniform(0.3, 0.9, size=(num_gaussians, 1))
    scene = init_scene(
        points.astype(np.float32),
        rho.astype(np.float32),
        pmin=volume_position - volume_size / 2,
        pmax=volume_position + volume_size / 2,
        max_sh_degree=max_sh_degree,
        knn_scale_init=False,
        device=device,
    )
    sigma = 0.06 * volume_size
    logit = gmath.inverse_sigmoid(torch.tensor(0.8, dtype=torch.float32))
    with torch.no_grad():
        scene.log_scales.fill_(float(np.float32(np.log(sigma))))
        scene.logit_opacities.fill_(float(logit))
    return scene
