"""Differentiable confocal transient rendering (PyTorch).

Port of `nlos_gaussian_renderer_tpu/ops/render.py` for the `dense`,
`analytic`, `pallas`, `pallas_rsort`, `pallas_analytic` and `pallas_dsort`
backends, with no occlusion, aggregate occlusion or per_gaussian occlusion
(`netf` / `nlos-neus`). For one scan point it renders the time-of-flight
histogram of the Gaussian scene by integrating the field over spherical
shells: field -> * sin(theta)/r^2 -> * volume_y^2 -> sum over angles ->
* dtheta * dphi.

The dense field is exp(-0.5 * X10 @ G10^T) @ weights (or the broadcast
difference form, `pdf_impl='direct'`), optionally chunked over Gaussians
with activation checkpointing (`gauss_chunk`), which is the reference the
kernels are held to at scale. Aggregate transmittance is exp(-cumsum) along
the radius axis. per_gaussian occlusion attenuates each Gaussian by its own
accumulated density, so it needs the un-reduced (sample, Gaussian) matrix:
every backend but `dense` renders it in Gaussian chunks
(`field_response_per_gaussian_chunked`), never through the kernels.

With `gauss_group` (a `torch.distributed` group over which the scene's rows
are sharded, `parallel/sharding.py`) every sum over Gaussians is summed
over the group (`gauss_sum`) before compositing, at JAX's `gauss_axis`
reduction points: exact in every mode, since each per-sample field is a
sum of per-Gaussian terms.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from nlos_gaussian_renderer_tpu_torch.models.scene import GaussianScene
from nlos_gaussian_renderer_tpu_torch.ops import math as gmath
from nlos_gaussian_renderer_tpu_torch.ops.analytic import analytic_field_response
from nlos_gaussian_renderer_tpu_torch.ops.fused import (
    TileSpec,
    cull_tiles,
    fused_gaussian_field,
)
from nlos_gaussian_renderer_tpu_torch.ops.fused_analytic import analytic_gaussian_field
from nlos_gaussian_renderer_tpu_torch.ops.fused_dsort import (
    dsort_cull,
    dsort_gaussian_field,
)
from nlos_gaussian_renderer_tpu_torch.ops.fused_rsort import (
    RSortSpec,
    rsort_cull,
    rsort_gaussian_field,
)
from nlos_gaussian_renderer_tpu_torch.ops.sampling import (
    ShellGrid,
    attenuation_weights,
    shell_grid,
)

BACKENDS = ("dense", "analytic", "pallas", "pallas_rsort", "pallas_analytic",
            "pallas_dsort")
# Every backend name the JAX package accepts; any other maps to 'dense'.
_JAX_BACKENDS = ("pallas", "pallas_rsort", "pallas_analytic", "pallas_dsort",
                 "analytic")
RSORT_FAMILY = ("pallas_rsort", "pallas_analytic")
KERNEL_BACKENDS = ("pallas",) + RSORT_FAMILY + ("pallas_dsort",)


class RenderSettings(NamedTuple):
    """Static rendering configuration.

    `backend` keeps the JAX package's names: 'dense' (plain tensor ops),
    'analytic' (closed-form erf sections, plain tensor ops), 'pallas' (the
    tile kernels K7/K8, capacity `tile_spec.k_max`), 'pallas_rsort' and
    'pallas_analytic' (the work-list kernels, capacities in `rsort_spec`)
    and 'pallas_dsort' (the duplicated layout on K1-K4, capacities
    `rsort_spec.d_max`, `dup_rows` and `w_max`; it takes no frozen layout,
    as in JAX).
    `pdf_impl` picks the dense field's Mahalanobis form: 'matmul' (the
    quadratic form against the point monomials) or 'direct' (the broadcast
    (A, N, 3) difference form, `math.mahalanobis_direct`).
    """

    num_sampling_points: int
    start: int
    end: int
    occlusion: bool = False
    rendering_type: str = "netf"  # 'netf' | 'nlos-neus'
    occlusion_mode: str = "aggregate"  # 'aggregate' | 'per_gaussian'
    scaling_modifier: float = 1.0
    apply_volume_y2_factor: bool = True
    pdf_impl: str = "matmul"  # 'matmul' | 'direct'
    backend: str = "dense"
    tile_spec: TileSpec = TileSpec()
    rsort_spec: RSortSpec = RSortSpec()

    @property
    def num_bins(self) -> int:
        return self.end - self.start

    @classmethod
    def from_config(cls, cfg) -> "RenderSettings":
        tile_spec = TileSpec()
        if getattr(cfg, "cull_tile", None) is not None:
            tt, tp, tr = cfg.cull_tile
            tile_spec = tile_spec._replace(t_theta=tt, t_phi=tp, t_r=tr)
        if getattr(cfg, "cull_k_max", None) is not None:
            tile_spec = tile_spec._replace(k_max=cfg.cull_k_max)
        # rsort radial schedule: ONE chunk covering the whole bin window
        # (rounded up to the gate size), which keeps w_max at O(blocks x
        # tiles).
        gate_bins = getattr(cfg, "rsort_gate_bins", None) or 8
        num_bins = cfg.end - cfg.start
        t_chunk = getattr(cfg, "rsort_t_chunk", None) or (
            -(-num_bins // gate_bins) * gate_bins
        )
        return cls(
            num_sampling_points=cfg.num_sampling_points,
            start=cfg.start,
            end=cfg.end,
            occlusion=cfg.occlusion,
            rendering_type=cfg.rendering_type,
            occlusion_mode=cfg.occlusion_mode,
            scaling_modifier=cfg.scaling_modifier,
            apply_volume_y2_factor=cfg.apply_volume_y2_factor,
            backend=cfg.renderer if cfg.renderer in _JAX_BACKENDS else "dense",
            tile_spec=tile_spec,
            rsort_spec=RSortSpec(t_chunk=t_chunk, gate_bins=gate_bins),
        )


def view_albedo(scene: GaussianScene, camera_pos, active_sh_degree):
    """(N,) rho = clamp(eval_sh(sh, normalize(mu - cam)) + 0.5, 0); bands
    above `active_sh_degree` are masked."""
    dirs = scene.means - camera_pos[None, :]
    dirs = dirs / torch.clamp(
        torch.linalg.vector_norm(dirs, dim=-1, keepdim=True), min=1e-12
    )
    sh_val = gmath.eval_sh_dynamic(
        scene.sh, dirs, active_sh_degree, scene.max_sh_degree
    )
    return torch.clamp(sh_val + 0.5, min=0.0)


def gaussian_pdf(scene: GaussianScene, points, settings: RenderSettings):
    """(A, N) unnormalized PDFs exp(-0.5 * maha) at (A, 3) points, maha by
    the settings' `pdf_impl`."""
    mod = settings.scaling_modifier
    if settings.pdf_impl == "matmul":
        gfeat = scene.quadratic_form(mod)
        maha = gmath.mahalanobis_matmul(gmath.point_monomials(points), gfeat)
    elif settings.pdf_impl == "direct":
        maha = gmath.mahalanobis_direct(points, scene.means, scene.scales * mod,
                                        scene.rotations)
    else:
        raise ValueError(f"pdf_impl={settings.pdf_impl!r}")
    return torch.exp(-0.5 * maha)


class GaussSum(torch.autograd.Function):
    """Forward: the sum of `x` over the ranks of `group` (an all-reduce).
    Backward: the cotangent unchanged. Every rank of the group computes the
    same loss from the summed value, so the cotangent is replicated and the
    derivative of the sum with respect to this rank's term is the identity
    (JAX's transpose of `psum` under `check_vma=False` sums it instead:
    `parallel/sharding.py`)."""

    @staticmethod
    def forward(ctx, x, group):
        y = torch.clone(x, memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def gauss_sum(x, gauss_group=None):
    """`x` summed over the Gaussian shards of `gauss_group` (JAX's psum
    over `gauss_axis`, through `GaussSum`); `x` itself without a group."""
    if gauss_group is None:
        return x
    return GaussSum.apply(x, gauss_group)


def _exclusive_cumsum(x, dim):
    return torch.cumsum(x, dim=dim) - x


def _pdf_weighted(xfeat, gfeat, weights):
    return torch.exp(-0.5 * gmath.mahalanobis_matmul(xfeat, gfeat)) @ weights


def _direct_weighted(points, means, scales, quats, weights):
    return torch.exp(-0.5 * gmath.mahalanobis_direct(points, means, scales, quats)) @ weights


def _gauss_chunked(fn, shared, per_gauss, gauss_chunk: Optional[int]):
    """sum over Gaussian chunks of fn(*shared, *chunk of each per_gauss
    tensor); each chunk is recomputed in the backward (activation
    checkpointing), so memory stays at one chunk's temporaries."""
    n = per_gauss[0].shape[0]
    if gauss_chunk is None or gauss_chunk >= n:
        return fn(*shared, *per_gauss)
    out = None
    for i in range(0, n, gauss_chunk):
        part_args = tuple(t[i:i + gauss_chunk] for t in per_gauss)
        if torch.is_grad_enabled() and any(t.requires_grad for t in part_args):
            part = checkpoint(fn, *shared, *part_args, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            part = fn(*shared, *part_args)
        out = part if out is None else out + part
    return out


def weighted_pdf_sums(xfeat, gfeat, weights, gauss_chunk: Optional[int] = None):
    """(A, C) = sum_n pdf[a, n] * weights[n, c]. With `gauss_chunk`, the sum
    runs over Gaussian chunks of that size, each recomputed in the backward
    (activation checkpointing), so memory stays at one (A, chunk) block."""
    return _gauss_chunked(_pdf_weighted, (xfeat,), (gfeat, weights), gauss_chunk)


def channel_weights(scene, camera_pos, active_sh_degree, settings):
    """(N, C) per-Gaussian channel weights: op * rho without occlusion,
    (op, op * rho) for aggregate occlusion."""
    op = scene.opacities[:, 0]
    rho = view_albedo(scene, camera_pos, active_sh_degree)
    if not settings.occlusion:
        return (op * rho)[:, None]
    if settings.occlusion_mode != "aggregate":
        # per_gaussian needs the un-reduced (sample, Gaussian) matrix: no
        # channel sum carries it (`render_transient` routes it around the
        # kernels, to `field_response_per_gaussian_chunked`).
        raise NotImplementedError(
            f"occlusion_mode={settings.occlusion_mode!r} has no channel weights"
        )
    return torch.stack([op, op * rho], dim=-1)


def _composite(both, c, delta_t, settings: RenderSettings):
    """(A, C) channel sums -> (A,) response for the settings' mode."""
    if not settings.occlusion:
        return both[:, 0]
    ns2 = settings.num_sampling_points**2
    both = both.reshape(settings.num_bins, ns2, 2)
    density, rho_density = both[..., 0], both[..., 1]
    cdt = c * delta_t
    if settings.rendering_type == "netf":
        trans = torch.exp(-cdt * _exclusive_cumsum(density, 0))
        out = rho_density * trans * cdt
    elif settings.rendering_type == "nlos-neus":
        alpha = 1.0 - torch.exp(-density * cdt)
        trans = torch.exp(_exclusive_cumsum(torch.log1p(-alpha + 1e-7), 0))
        mean_rho = rho_density / torch.clamp(density, min=1e-12)
        out = alpha * trans * mean_rho
    else:
        raise ValueError(settings.rendering_type)
    return out.reshape(-1)


def _per_gaussian_response(density, rho, cdt, rendering_type: str):
    """(num_r, ns^2) response of per_gaussian occlusion from the (num_r,
    ns^2, N) densities pdf * op: each Gaussian attenuated by its own
    accumulated density along r, in the reference's arithmetic (the 1e-7
    inside the log of its cumprod, `gaussian_model.py:316-339`)."""
    if rendering_type == "netf":
        log_occ = torch.log(torch.exp(-density * cdt) + 1e-7)
        trans = torch.exp(_exclusive_cumsum(log_occ, 0))
        return torch.sum(density * trans * rho, dim=-1) * cdt
    if rendering_type == "nlos-neus":
        alpha = 1.0 - torch.exp(-density * cdt)
        trans = torch.exp(_exclusive_cumsum(torch.log(1.0 - alpha + 1e-7), 0))
        return torch.sum(alpha * trans * rho, dim=-1)
    raise ValueError(rendering_type)


def _is_per_gaussian(settings: RenderSettings) -> bool:
    if settings.occlusion and settings.occlusion_mode not in ("aggregate", "per_gaussian"):
        raise ValueError(settings.occlusion_mode)
    return settings.occlusion and settings.occlusion_mode == "per_gaussian"


def field_response(scene: GaussianScene, points, camera_pos, c, delta_t,
                   active_sh_degree, settings: RenderSettings,
                   gauss_chunk: Optional[int] = None, gauss_group=None):
    """(A,) rho-weighted emission at (A, 3) points, A = num_r * ns^2:
    no occlusion: sum_g pdf * op * rho; aggregate netf:
    (sum pdf*op*rho) * T * c*dt with T = exp(-c*dt * excl-cumsum_r(sum pdf*op));
    aggregate nlos-neus: the alpha-compositing analogue; per_gaussian: the
    same with each Gaussian's own transmittance (`_per_gaussian_response`),
    on the whole (A, N) matrix, or with `gauss_chunk` in Gaussian chunks
    (`field_response_per_gaussian_chunked`). With `gauss_group` the sums
    over Gaussians are summed over the group's shards (`gauss_sum`); the
    per_gaussian branch is too, where JAX's dense branch has no psum."""
    if _is_per_gaussian(settings):
        if gauss_chunk is not None:
            return field_response_per_gaussian_chunked(
                scene, points, camera_pos, c, delta_t, active_sh_degree, settings,
                gauss_chunk, gauss_group)
        ns2 = settings.num_sampling_points**2
        density = (gaussian_pdf(scene, points, settings) * scene.opacities[:, 0]
                   ).reshape(settings.num_bins, ns2, -1)
        rho = view_albedo(scene, camera_pos, active_sh_degree)
        return gauss_sum(_per_gaussian_response(density, rho, c * delta_t,
                                                settings.rendering_type).reshape(-1),
                         gauss_group)
    w = channel_weights(scene, camera_pos, active_sh_degree, settings)
    mod = settings.scaling_modifier
    if settings.pdf_impl == "matmul":
        both = weighted_pdf_sums(gmath.point_monomials(points), scene.quadratic_form(mod),
                                 w, gauss_chunk)
    elif settings.pdf_impl == "direct":
        both = _gauss_chunked(_direct_weighted, (points,),
                              (scene.means, scene.scales * mod, scene.rotations, w),
                              gauss_chunk)
    else:
        raise ValueError(f"pdf_impl={settings.pdf_impl!r}")
    return _composite(gauss_sum(both, gauss_group), c, delta_t, settings)


def field_response_per_gaussian_chunked(scene: GaussianScene, points, camera_pos, c,
                                        delta_t, active_sh_degree,
                                        settings: RenderSettings,
                                        gauss_chunk: Optional[int] = None,
                                        gauss_group=None):
    """per_gaussian occlusion's (A,) response in Gaussian chunks: each
    Gaussian's transmittance depends on its own density only, so the sum
    over Gaussians chunks exactly. Memory holds one chunk's (A, chunk)
    temporaries: each chunk is recomputed in the backward (activation
    checkpointing). The default chunk is JAX's, max(64, 80e6 // (4 A));
    the last chunk wraps around to row 0 with zero opacity. The quadratic
    form is always the matmul one, as in JAX."""
    ns2 = settings.num_sampling_points**2
    num_r = settings.num_bins
    a = num_r * ns2
    if gauss_chunk is None:
        gauss_chunk = max(64, int(80e6 // max(4 * a, 1)))
    n = scene.capacity
    chunk = min(gauss_chunk, n)
    pad = (-n) % chunk
    dev = scene.means.device
    idx = torch.arange(n + pad, device=dev) % n
    valid = (torch.arange(n + pad, device=dev) < n).to(scene.means.dtype)
    gfeat = scene.quadratic_form(settings.scaling_modifier)[idx]
    op = scene.opacities[:, 0][idx] * valid
    rho = view_albedo(scene, camera_pos, active_sh_degree)[idx]
    xfeat = gmath.point_monomials(points)
    cdt = c * delta_t

    def body(xf, gf, o, rh):
        maha = gmath.mahalanobis_matmul(xf, gf)  # (A, chunk)
        density = (torch.exp(-0.5 * maha) * o[None, :]).reshape(num_r, ns2, -1)
        return _per_gaussian_response(density, rh, cdt, settings.rendering_type)

    return gauss_sum(_gauss_chunked(body, (xfeat,), (gfeat, op, rho), chunk).reshape(-1),
                     gauss_group)


def field_response_pallas(scene: GaussianScene, grid: ShellGrid, camera_pos,
                          c, delta_t, active_sh_degree, settings: RenderSettings,
                          layout=None, gauss_group=None):
    """`field_response` through the kernels of the settings' backend:
    'pallas' (tile cull, K7/K8), 'pallas_rsort' (rsort cull, sampled field),
    'pallas_analytic' (rsort cull, exact per-bin integrals) or
    'pallas_dsort' (duplicated cull, sampled field), without occlusion or
    with aggregate occlusion. `layout` (an `fused_rsort.RSortLayout`,
    rsort family only; 'pallas_dsort' ignores it, as in JAX) replaces the
    cull's sort with a frozen block layout. With `gauss_group` the field is
    summed over the group's shards before compositing. Returns ((A,)
    response, this shard's overflow flag)."""
    if settings.backend not in KERNEL_BACKENDS:
        raise NotImplementedError(f"backend {settings.backend!r} is not ported")
    w = channel_weights(scene, camera_pos, active_sh_degree, settings)
    gfeat = scene.quadratic_form(settings.scaling_modifier)
    spec = settings.rsort_spec
    if settings.backend == "pallas":
        tiles = cull_tiles(scene.means, scene.scales, scene.alive, camera_pos,
                           grid.theta, grid.phi, grid.r, settings.tile_spec,
                           settings.scaling_modifier)
        field, overflow = fused_gaussian_field(gfeat, w, grid.points.detach(), tiles,
                                               settings.tile_spec)
    elif settings.backend == "pallas_dsort":
        tiles = dsort_cull(scene.means, scene.scales, scene.alive, camera_pos, grid.theta,
                           grid.phi, grid.r, spec, settings.scaling_modifier)
        field, overflow = dsort_gaussian_field(gfeat, w, tiles, spec, grid, camera_pos)
    else:
        tiles = rsort_cull(
            scene.means, scene.scales, scene.alive, camera_pos, grid.theta,
            grid.phi, grid.r, spec, settings.scaling_modifier, layout=layout,
            gw=torch.cat([gfeat, w], dim=1),
        )
        if settings.backend == "pallas_analytic":
            field, overflow = analytic_gaussian_field(gfeat, w, grid, tiles, spec,
                                                      camera_pos)
        else:
            field, overflow = rsort_gaussian_field(gfeat, w, tiles, spec, grid,
                                                   camera_pos)
    both = gauss_sum(field.reshape(-1, w.shape[1]), gauss_group)
    return _composite(both, c, delta_t, settings), overflow


@torch.no_grad()
def check_culling_capacity(scene: GaussianScene, camera_pos, box_points, c,
                           delta_t, settings: RenderSettings) -> dict:
    """Cull one representative scan point and report whether the kernel
    backends' static capacities saturate: {'backend', 'overflowed', ...}
    (the tile backend's `k_max`, the rsort family's `w_max` and
    `max_groups`, dsort's `d_max`, its rows and `w_max`). Backends without
    capacities report no overflow."""
    if settings.backend not in BACKENDS:
        raise NotImplementedError(f"backend {settings.backend!r} is not ported")
    if settings.backend not in KERNEL_BACKENDS:
        return {"backend": settings.backend, "overflowed": False}
    grid = shell_grid(camera_pos, box_points, settings.num_sampling_points,
                      settings.start, settings.end, c, delta_t)
    if settings.backend == "pallas":
        t = cull_tiles(scene.means, scene.scales, scene.alive, camera_pos,
                       grid.theta, grid.phi, grid.r, settings.tile_spec,
                       settings.scaling_modifier)
        return {
            "backend": "pallas",
            "overflowed": bool(t.overflowed),
            "max_count": int(torch.max(t.counts)),
            "k_max": settings.tile_spec.k_max,
        }
    spec = settings.rsort_spec
    if settings.backend == "pallas_dsort":
        t = dsort_cull(scene.means, scene.scales, scene.alive, camera_pos, grid.theta,
                       grid.phi, grid.r, spec, settings.scaling_modifier)
        return {
            "backend": "pallas_dsort",
            "overflowed": bool(t.overflowed),
            "max_dups": int(t.max_dups),
            "d_max": spec.d_max,
            "n_rows": int(t.n_rows),
            "n_items": int(t.n_items[0]),
            "w_max": spec.w_max,
        }
    t = rsort_cull(scene.means, scene.scales, scene.alive, camera_pos,
                   grid.theta, grid.phi, grid.r, spec, settings.scaling_modifier)
    return {
        "backend": settings.backend,
        "overflowed": bool(t.overflowed),
        "max_count": int(torch.max(t.counts)),
        "n_groups": int(t.n_groups),
        "max_groups": spec.max_groups,
        "n_items": int(t.n_items[0]),
        "w_max": spec.w_max,
    }


def render_transient(scene: GaussianScene, camera_pos, box_points, c, delta_t,
                     volume_position, active_sh_degree,
                     settings: RenderSettings,
                     gauss_chunk: Optional[int] = None, layout=None, gauss_group=None):
    """Render (transient (num_r, ns^2), histogram (num_r,), overflow ()).

    `overflow` is True when a kernel backend's static capacity saturated (a
    tile list or the rsort work list; contributions were dropped, or a
    frozen `layout` had no slot for a Gaussian this camera sees); it is
    constant False on the dense and analytic backends and for per_gaussian
    occlusion, which every backend but 'dense' renders in Gaussian chunks
    (`field_response_per_gaussian_chunked`). `gauss_chunk` chunks the dense,
    analytic and per_gaussian sums over Gaussians; `layout` applies to the
    rsort family. With `gauss_group` the scene is this rank's shard of a
    Gaussian-sharded scene: the field is summed over the group, so every
    rank of it returns the whole scene's render, and `overflow` is this
    shard's flag (the sharded step reduces it).
    """
    if settings.backend not in BACKENDS:
        raise NotImplementedError(f"backend {settings.backend!r} is not ported")
    grid = shell_grid(
        camera_pos, box_points, settings.num_sampling_points, settings.start,
        settings.end, c, delta_t,
    )
    overflow = torch.zeros((), dtype=torch.bool, device=camera_pos.device)
    per_gaussian = _is_per_gaussian(settings)
    if per_gaussian and settings.backend != "dense":
        out = field_response_per_gaussian_chunked(
            scene, grid.points.reshape(-1, 3), camera_pos, c, delta_t,
            active_sh_degree, settings, gauss_chunk, gauss_group,
        )
    elif settings.backend in KERNEL_BACKENDS:
        out, overflow = field_response_pallas(
            scene, grid, camera_pos, c, delta_t, active_sh_degree, settings,
            layout=layout, gauss_group=gauss_group,
        )
    elif settings.backend == "analytic":
        out = analytic_field_response(
            scene, grid, camera_pos, c, delta_t, active_sh_degree, settings,
            gauss_chunk, gauss_group,
        )
    else:
        out = field_response(
            scene, grid.points.reshape(-1, 3), camera_pos, c, delta_t,
            active_sh_degree, settings, gauss_chunk, gauss_group,
        )
    result = out.reshape(settings.num_bins, settings.num_sampling_points**2)
    result = result * attenuation_weights(grid)
    if settings.apply_volume_y2_factor:
        result = result * (volume_position[1] ** 2)
    hist = torch.sum(result, dim=1) * grid.dtheta * grid.dphi
    return result, hist, overflow


def render_histogram(scene, camera_pos, box_points, c, delta_t, volume_position,
                     active_sh_degree, settings: RenderSettings):
    """(num_r,) histogram only."""
    return render_transient(scene, camera_pos, box_points, c, delta_t,
                            volume_position, active_sh_degree, settings)[1]


def render_histogram_batch(scene, camera_positions, box_points, c, delta_t,
                           volume_position, active_sh_degree,
                           settings: RenderSettings):
    """(B, num_r) histograms of a batch of scan points, one render per
    camera (the JAX version's sequential map of the kernel backends; its
    vmap of the dense ones computes the same rows)."""
    return torch.stack([
        render_histogram(scene, cam, box_points, c, delta_t, volume_position,
                         active_sh_degree, settings)
        for cam in camera_positions
    ])


def mse_loss(pred_hist, target_hist):
    """(MSE, MSE normalized by mean(target^2)); target already * gt_times."""
    loss = torch.mean((pred_hist - target_hist) ** 2)
    loss_coffe = torch.mean(target_hist**2)
    return loss, loss / torch.clamp(loss_coffe, min=1e-20)
