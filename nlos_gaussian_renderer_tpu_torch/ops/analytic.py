"""Closed-form (erf) section integration of Gaussians along shell rays.

Port of `nlos_gaussian_renderer_tpu/ops/analytic.py`: the `analytic` backend
and the reference the `pallas_analytic` kernels are held to at scale.

Along a ray x(t) = o + t*w (|w| = 1) a Gaussian's squared Mahalanobis is the
quadratic a + b t + c t^2 with
    u = diag(1/s) R (o - mu),   v = diag(1/s) R w,
    a = u.u,  b = 2 u.v,  c = v.v,
so the optical depth of the time bin [t0, t1] is
    tau = E * 0.5 * sqrt(2*pi/c) * (erf(z1) - erf(z0)),
    E = exp(-0.5*(a - b^2/(4c))),  z(t) = sqrt(c/2) * (t + b/(2c)).
Every bin edge gets its own erf, so each section deposits exactly its
integral into each bin it spans; per-bin values are tau / bin_width.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from nlos_gaussian_renderer_tpu_torch.models.scene import GaussianScene
from nlos_gaussian_renderer_tpu_torch.ops import math as gmath
from nlos_gaussian_renderer_tpu_torch.ops.sampling import ShellGrid


def _ray_quadratics(means, scales, rotations, cam, dirs):
    """(a (N,), b (R, N), c (R, N)) from activated parameters; the sums are
    unrolled in the JAX version's order."""
    rot = gmath.quat_to_rotmat(rotations)  # (N, 3, 3)
    inv_s = 1.0 / scales
    m = inv_s[:, :, None] * rot  # diag(1/s) R
    diff = cam[None, :] - means  # (N, 3)
    u = [sum(m[:, i, j] * diff[:, j] for j in range(3)) for i in range(3)]
    v = [
        sum(m[None, :, i, j] * dirs[:, None, j] for j in range(3))
        for i in range(3)
    ]
    a = sum(u[i] * u[i] for i in range(3))
    b = 2.0 * sum(v[i] * u[i][None, :] for i in range(3))
    c = torch.clamp(sum(v[i] * v[i] for i in range(3)), min=1e-12)
    return a, b, c


def ray_quadratics(scene: GaussianScene, cam, dirs, scaling_modifier=1.0):
    """Per (ray, Gaussian) quadratic coefficients of the Mahalanobis along t.

    cam (3,) ray origin; dirs (R, 3) unit directions. Returns
    (a (N,), b (R, N), c (R, N))."""
    return _ray_quadratics(scene.means, scene.scales * scaling_modifier,
                           scene.rotations, cam, dirs)


def section_bin_integrals(a, b, c, edges):
    """(K, R, N) integrals of exp(-0.5 * (a + b t + c t^2)) over the K bins
    of the monotone edges (K+1,); a (N,), b and c (R, N)."""
    inv2c = 0.5 / c
    peak = torch.exp(-0.5 * torch.clamp(a[None, :] - b * b * inv2c * 0.5, min=0.0))
    scale = 0.5 * torch.sqrt(2.0 * math.pi / c)
    sqrt_half_c = torch.sqrt(0.5 * c)
    shift = b * inv2c  # b / (2c)
    z = sqrt_half_c[None] * (edges[:, None, None] + shift[None])  # (K+1, R, N)
    cdf = torch.erf(z)
    return (peak * scale)[None] * (cdf[1:] - cdf[:-1])


def bin_edges_from_grid(r):
    """Midpoint bin edges (K+1,) of the shell radius grid (K,)."""
    mid = 0.5 * (r[1:] + r[:-1])
    first = r[0] - (mid[0] - r[0])
    last = r[-1] + (r[-1] - mid[-1])
    return torch.cat([first[None], mid, last[None]])


def grid_dirs(grid: ShellGrid):
    """(ns*ns, 3) unit ray directions, (theta, phi) order of `grid.points`."""
    ns = grid.theta.shape[0]
    sin_t = torch.sin(grid.theta)
    dirs = torch.stack(
        [
            sin_t[:, None] * torch.cos(grid.phi)[None, :],
            sin_t[:, None] * torch.sin(grid.phi)[None, :],
            torch.cos(grid.theta)[:, None].expand(ns, ns),
        ],
        dim=-1,
    )
    return dirs.reshape(ns * ns, 3)


def _chunk_field(means, scales, rotations, w, cam, dirs, edges):
    a, b, c = _ray_quadratics(means, scales, rotations, cam, dirs)
    taus = section_bin_integrals(a, b, c, edges)  # (K, R, chunk)
    return taus @ w  # (K, R, C)


def analytic_field(scene: GaussianScene, grid: ShellGrid, camera_pos,
                   channel_weights, scaling_modifier: float = 1.0,
                   gauss_chunk: Optional[int] = None):
    """Per-(bin, ray) field averages (num_r, ns*ns, C):
    value[k, ray, c] = sum_g w[g, c] * tau_g(bin k) / bin_width.

    The sum runs over Gaussian chunks, each recomputed in the backward
    (activation checkpointing), so memory holds one (K+1, R, chunk) block:
    unchunked, 100k Gaussians x 200 bins x 32^2 rays would be ~82 GB. When
    `gauss_chunk` is None a chunk of ~200 MB per temporary is derived from
    the grid shape, as the JAX version does."""
    ns = grid.theta.shape[0]
    num_r = grid.r.shape[0]
    if gauss_chunk is None:
        per_g_bytes = 4 * (num_r + 1) * (ns * ns)
        gauss_chunk = max(64, int(200e6 // max(per_g_bytes, 1)))
    dirs = grid_dirs(grid)
    edges = bin_edges_from_grid(grid.r)
    widths = edges[1:] - edges[:-1]
    means = scene.means
    scales = scene.scales * scaling_modifier
    rotations = scene.rotations
    out = None
    for i in range(0, scene.capacity, gauss_chunk):
        args = (means[i:i + gauss_chunk], scales[i:i + gauss_chunk],
                rotations[i:i + gauss_chunk], channel_weights[i:i + gauss_chunk],
                camera_pos, dirs, edges)
        if torch.is_grad_enabled() and any(x.requires_grad for x in args[:4]):
            part = checkpoint(_chunk_field, *args, use_reentrant=False)
        else:
            part = _chunk_field(*args)
        out = part if out is None else out + part
    return out / widths[:, None, None]


def analytic_field_response(scene: GaussianScene, grid: ShellGrid, camera_pos,
                            c, delta_t, active_sh_degree, settings,
                            gauss_chunk: Optional[int] = None, gauss_group=None):
    """Analytic counterpart of `render.field_response`, flattened (A,): no
    occlusion, or aggregate `netf` / `nlos-neus` with the numerical path's
    discrete exp(-cumsum) transmittance. `per_gaussian` raises, as in JAX:
    `render_transient` renders that mode in Gaussian chunks
    (`render.field_response_per_gaussian_chunked`), so only a direct call
    reaches the guard. With `gauss_group` (a Gaussian-sharded scene) the
    per-channel fields are summed over the group before compositing."""
    from nlos_gaussian_renderer_tpu_torch.ops.gaussian_rows import channel_weights
    from nlos_gaussian_renderer_tpu_torch.ops.render import _composite, gauss_sum

    if settings.occlusion and settings.occlusion_mode != "aggregate":
        raise NotImplementedError(
            "per_gaussian occlusion has no analytic field: render_transient renders it "
            "with field_response_per_gaussian_chunked")
    w = channel_weights(scene, camera_pos, active_sh_degree, settings)
    field = analytic_field(scene, grid, camera_pos, w, settings.scaling_modifier,
                           gauss_chunk)
    return _composite(gauss_sum(field.reshape(-1, w.shape[1]), gauss_group), c, delta_t,
                      settings)
