"""Tiled sample layout shared by the work-list kernels.

Port of the tiling half of `nlos_gaussian_renderer_tpu/ops/fused.py`
(`_tile_points_centered_direct_pts`, `tile_points_centered_direct_t`,
`untile_field_t`). Tiles are ordered (r_t, theta_t, phi_t) and samples
within a tile (r, theta, phi); monomials are centred at each tile's sample
centroid, which keeps the f32 quadratic form well conditioned.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from nlos_gaussian_renderer_tpu_torch.ops import math as gmath

FDIM = gmath.QUADRATIC_DIM  # 10


class TileSpec(NamedTuple):
    """Static tiling of the (r, theta, phi) sample grid."""

    t_theta: int = 8
    t_phi: int = 16
    t_r: int = 64


def _pad_axis(v, tile: int, n_tiles: int):
    """(n,) axis values -> (n_tiles, tile), extrapolating the grid step."""
    extra = n_tiles * tile - v.shape[0]
    if extra:
        step = v[-1] - v[-2] if v.shape[0] >= 2 else torch.zeros((), dtype=v.dtype, device=v.device)
        ar = torch.arange(1, extra + 1, dtype=v.dtype, device=v.device)
        v = torch.cat([v, v[-1] + step * ar])
    return v.reshape(n_tiles, tile)


def _tile_points_centered_direct_pts(theta, phi, r, cam, spec: TileSpec,
                                     n_tt: int, n_pt: int, n_rt: int):
    """Tile-major (T, S, 3) sample points + (T, 3) tile centroids."""
    th = _pad_axis(theta, spec.t_theta, n_tt)
    ph = _pad_axis(phi, spec.t_phi, n_pt)
    rr = _pad_axis(r, spec.t_r, n_rt)
    sin_t = torch.sin(th)[:, None, :, None]
    cos_t = torch.cos(th)[:, None, :, None]
    cos_p = torch.cos(ph)[None, :, None, :]
    sin_p = torch.sin(ph)[None, :, None, :]
    dirs = torch.stack(
        [
            sin_t * cos_p,
            sin_t * sin_p,
            cos_t.expand(n_tt, n_pt, spec.t_theta, spec.t_phi),
        ],
        dim=-1,
    )
    pts = rr[:, None, None, :, None, None, None] * dirs[None, :, :, None, :, :, :] + cam
    t = n_rt * n_tt * n_pt
    s = spec.t_r * spec.t_theta * spec.t_phi
    pts = pts.reshape(t, s, 3)
    return pts, torch.mean(pts, dim=1)


def tile_points_centered_direct_t(theta, phi, r, cam, spec: TileSpec,
                                  n_tt: int, n_pt: int, n_rt: int):
    """(xfeat_t (T, 10, S) centred monomial rows, centers (T, 3)) with
    samples on the minor axis — the kernels' layout."""
    xf, centers = _tile_points_centered_direct_pts(
        theta, phi, r, cam, spec, n_tt, n_pt, n_rt
    )
    cx = xf[..., 0] - centers[:, None, 0]
    cy = xf[..., 1] - centers[:, None, 1]
    cz = xf[..., 2] - centers[:, None, 2]
    rows = torch.stack(
        [cx * cx, cy * cy, cz * cz, cx * cy, cx * cz, cy * cz,
         cx, cy, cz, torch.ones_like(cx)],
        dim=1,
    )
    return rows, centers


def untile_field_t(out, ns: int, num_r: int, spec: TileSpec,
                   n_tt: int, n_pt: int, n_rt: int):
    """(T, C, S) tiled field -> (num_r, ns, ns, C)."""
    c = out.shape[1]
    full = out.reshape(
        n_rt, n_tt, n_pt, c, spec.t_r, spec.t_theta, spec.t_phi
    ).permute(0, 4, 1, 5, 2, 6, 3)
    full = full.reshape(
        n_rt * spec.t_r, n_tt * spec.t_theta, n_pt * spec.t_phi, c
    )
    return full[:num_r, :ns, :ns]
