"""Spherical-shell sampling of the hidden volume for confocal transients.

Port of `nlos_gaussian_renderer_tpu/ops/sampling.py`: for one scan point, a
(num_bins, ns, ns) grid over (radius <-> time bin, polar theta, azimuth phi),
bounded by the spherical coordinates of the hidden volume's 8 corners.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from nlos_gaussian_renderer_tpu_torch.ops import math as gmath


class ShellGrid(NamedTuple):
    """Sampling grid for one scan point.

    points: (num_r, ns, ns, 3) world-space samples; r: (num_r,) radii;
    theta, phi: (ns,) angles; dtheta, dphi: 0-d angular steps ((max-min)/ns).
    """

    points: torch.Tensor
    r: torch.Tensor
    theta: torch.Tensor
    phi: torch.Tensor
    dtheta: torch.Tensor
    dphi: torch.Tensor
    theta_min: torch.Tensor
    theta_max: torch.Tensor
    phi_min: torch.Tensor
    phi_max: torch.Tensor


def _linspace(lo, hi, n: int):
    """Inclusive linspace between 0-d tensors (device-resident bounds, no
    host sync), in `jnp.linspace`'s form: lo * (1 - s) + hi * s with
    s = i / (n - 1), and the end point exactly `hi`."""
    if n == 1:
        return lo.reshape(1)
    step = torch.arange(n - 1, dtype=lo.dtype, device=lo.device) / (n - 1)
    out = lo * (1 - step) + hi * step
    return torch.cat([out, hi.reshape(1)])


def shell_grid(
    camera_pos,
    box_points,
    num_sampling_points: int,
    start: int,
    end: int,
    c: float,
    delta_t: float,
) -> ShellGrid:
    """Spherical sampling grid for one confocal scan point.

    camera_pos (3,) and box_points (8, 3) are tensors on one device; the grid
    lies on that device. r = linspace(start, end) * c * delta_t with
    num_r = end - start points; dtheta = (max - min) / ns.
    """
    ns = num_sampling_points
    num_r = end - start
    rel = box_points - camera_pos[None, :]
    sph = gmath.cartesian_to_spherical(rel)  # (8, 3)
    theta_min = torch.min(sph[:, 1])
    theta_max = torch.max(sph[:, 1])
    phi_min = torch.min(sph[:, 2])
    phi_max = torch.max(sph[:, 2])

    theta = _linspace(theta_min, theta_max, ns)
    phi = _linspace(phi_min, phi_max, ns)
    dtheta = (theta_max - theta_min) / ns
    dphi = (phi_max - phi_min) / ns

    # Fills, not host copies: a captured step copies nothing from the host.
    like = dict(dtype=camera_pos.dtype, device=camera_pos.device)
    r_lo = torch.full((), start * c * delta_t, **like)
    r_hi = torch.full((), end * c * delta_t, **like)
    r = _linspace(r_lo, r_hi, num_r)

    sin_t = torch.sin(theta)
    dirs = torch.stack(
        [
            sin_t[:, None] * torch.cos(phi)[None, :],
            sin_t[:, None] * torch.sin(phi)[None, :],
            torch.cos(theta)[:, None].expand(ns, ns),
        ],
        dim=-1,
    )
    points = r[:, None, None, None] * dirs[None] + camera_pos
    return ShellGrid(
        points=points,
        r=r,
        theta=theta,
        phi=phi,
        dtheta=dtheta,
        dphi=dphi,
        theta_min=theta_min,
        theta_max=theta_max,
        phi_min=phi_min,
        phi_max=phi_max,
    )


def attenuation_weights(grid: ShellGrid) -> torch.Tensor:
    """(num_r, ns*ns) radiometric attenuation sin(theta) / r^2."""
    ns = grid.theta.shape[0]
    sin_theta = torch.sin(grid.theta)[:, None].expand(ns, ns)
    return sin_theta.reshape(1, ns * ns) / (grid.r[:, None] ** 2)

