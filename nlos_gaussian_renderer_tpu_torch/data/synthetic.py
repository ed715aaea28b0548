"""Synthetic confocal NLOS scenes and datasets (numpy-seeded).

Port of `nlos_gaussian_renderer_tpu/data/synthetic.py`: the same numpy draws
give the same scene in both packages, and `make_synthetic_dataset` renders
its ground-truth transients with the port's own forward model into an
`NLOSData` of the Zaragoza schema. The visible wall is the y=0 plane scanned
over an (x, z) grid; the hidden volume sits at positive y.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from nlos_gaussian_renderer_tpu_torch.data.zaragoza import NLOSData
from nlos_gaussian_renderer_tpu_torch.models.scene import GaussianScene, init_scene
from nlos_gaussian_renderer_tpu_torch.ops import math as gmath
from nlos_gaussian_renderer_tpu_torch.ops.render import (
    RenderSettings,
    render_histogram_batch,
)


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


def make_synthetic_dataset(
    seed: int = 0,
    scan_m: int = 8,
    scan_n: int = 8,
    num_bins: int = 128,
    num_gt_gaussians: int = 16,
    volume_distance: float = 1.0,
    volume_size: float = 0.6,
    num_sampling_points: int = 16,
    start: Optional[int] = None,
    end: Optional[int] = None,
    settings: Optional[RenderSettings] = None,
    return_scene: bool = False,
    device=None,
):
    """Generate a synthetic confocal dataset by forward-rendering a GT scene.

    The total number of time bins L = num_bins; the rendered/supervised window
    [start, end) defaults to bins that bracket the volume's radial extent.
    The GT scene and its renders lie on `device` (by default the CUDA card);
    the scan points are rendered 256 at a time and the histograms brought
    to the host a chunk at a time.

    Returns:
      NLOSData (and the GT GaussianScene if return_scene).
    """
    dev = gmath.default_device(device)
    rng = np.random.default_rng(seed)
    volume_position = np.array([0.0, volume_distance, 0.0], dtype=np.float32)
    c = 1.0
    # Radial window covered by the volume from the farthest scan corner, with
    # margin; choose deltaT so the full volume fits inside [0, num_bins).
    r_far = volume_distance + volume_size
    delta_t = float(r_far * 1.25 / num_bins)
    if start is None:
        start = max(int((volume_distance - volume_size) / (c * delta_t)) - 2, 1)
    if end is None:
        end = min(int(r_far / (c * delta_t)) + 2, num_bins)

    if settings is None:
        settings = RenderSettings(
            num_sampling_points=num_sampling_points, start=start, end=end
        )
    else:
        settings = settings._replace(start=start, end=end)

    scene = make_ground_truth_scene(
        rng, num_gt_gaussians, volume_position, volume_size, device=dev
    )
    box_points = gmath.volume_box_points(volume_position, volume_size, device=dev)
    vol = torch.as_tensor(volume_position, device=dev)
    cam_grid = make_scan_grid(scan_m, scan_n)

    # Chunk the scan points as the JAX version does (256 a dispatch): the
    # dense GT render materializes an (ns^2 * num_r, N_gt) matrix a camera.
    cams_all = torch.as_tensor(np.asarray(cam_grid.T, dtype=np.float32), device=dev)
    mn = cams_all.shape[0]
    cam_chunk = min(256, mn)
    with torch.no_grad():
        hists = np.concatenate([
            render_histogram_batch(
                scene, cams_all[i:i + cam_chunk], box_points, c, delta_t, vol,
                scene.max_sh_degree, settings,
            ).cpu().numpy()
            for i in range(0, mn, cam_chunk)
        ], axis=0)  # (MN, num_r)

    nlos = np.zeros((num_bins, scan_m, scan_n), dtype=np.float32)
    nlos[start:end] = hists.T.reshape(end - start, scan_m, scan_n)

    data = NLOSData(
        nlos_data=nlos,
        camera_position=np.array([0.0, -1.0, 0.0], dtype=np.float32),
        camera_grid_size=np.array([0.8, 0.8], dtype=np.float32),
        camera_grid_positions=cam_grid,
        camera_grid_points=np.array([scan_m, scan_n], dtype=np.int32),
        volume_position=volume_position,
        volume_size=float(volume_size),
        deltaT=delta_t,
        c=c,
    )
    if return_scene:
        return data, scene
    return data
