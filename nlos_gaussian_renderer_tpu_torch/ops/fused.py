"""Tile-sparse Gaussian field ('pallas' tile backend) and the tiled sample
layout shared with the work-list kernels.

Port of `nlos_gaussian_renderer_tpu/ops/fused.py`. One render of one scan
point through the tile backend:

  1. **Cull** (`cull_tiles`): each Gaussian's 3-sigma sphere is projected to
     a (theta, phi, r) footprint around the scan point, and every
     (r, theta, phi) tile it can touch is marked.
  2. **Compact**: per tile, the ids of its Gaussians in ascending order,
     into a list of static capacity `k_max` (`CompactTiles`; a tile with
     more Gaussians than that is truncated and reported in `overflowed`).
  3. **Gather** (`take_rows`): forms and channel weights ride one row gather
     into the (T, k_max, 10 + C) per-tile lists; its backward is one
     `index_add_` a tile, in tile order (a fixed summation order).
  4. **Field** (`FusedField`): kernel K7 (`field_fwd`) sums each sample's
     tile list, kernel K8 (`field_bwd`) gives the lists' cotangents.

The tile backend evaluates the quadratic form UNCENTRED (`tile_points`, the
function JAX computes): terms of ~(|x| / sigma)^2 cancel, so the plain
versions and the kernels spell the form in one fixed order (`quad_form`,
`quad` in `csrc/common.cuh`). Each kernel wrapper launches its CUDA kernel
for CUDA tensors and raises on anything it cannot take; for CPU tensors it
runs the plain PyTorch version beside it. The JAX `TileSpec`'s TPU block
sizes (`a_sub`, `g_tile`, `precision`) are not ported: the CUDA kernels
choose their own blocking, cut each tile into 32-sample patches by its
sample shape (`patch_dims`), and skip the (row, patch) pairs where a
conservative test proves every exp is exactly 0 (`_skip_plain`).

The tiling helpers of the work-list kernels (`tile_points_centered_direct_t`,
`untile_field_t`) live here too: tiles ordered (r_t, theta_t, phi_t),
samples within a tile (r, theta, phi), monomials centred at each tile's
sample centroid.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from nlos_gaussian_renderer_tpu_torch.ops import math as gmath
from nlos_gaussian_renderer_tpu_torch.ops.cuda_build import (
    KERNELS,
    check_tensor,
    on_cpu,
    ptr,
)

FDIM = gmath.QUADRATIC_DIM  # 10


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _topk_compaction(g: int, n_tiles: int) -> bool:
    """The JAX package's compaction selector: `lax.top_k` (pad slots hold
    real ids) above 1e6 (Gaussian, tile) pairs, a cumsum scatter (pad slots
    hold 0) below. `cull_tiles` fills its pad slots the same way."""
    return g * n_tiles > 1_000_000


class TileSpec(NamedTuple):
    """Static tiling of the (r, theta, phi) sample grid and the cull's
    capacity; the JAX `TileSpec`'s fields and defaults less its TPU block
    sizes."""

    t_theta: int = 8
    t_phi: int = 16
    t_r: int = 64
    k_max: int = 2048  # per-tile Gaussian capacity
    sigma_cull: float = 3.0
    margin: float = 1.1  # safety factor on angular footprints


class CompactTiles(NamedTuple):
    """Per-tile compacted Gaussian lists of one cull."""

    indices: torch.Tensor  # (T, k_max) int32 Gaussian ids, ascending prefix
    counts: torch.Tensor  # (T,) int32 valid ids per tile (<= k_max)
    slot_valid: torch.Tensor  # (T, k_max) float32 1/0
    overflowed: torch.Tensor  # () bool, any tile truncated


def tile_grid_dims(ns: int, num_r: int, spec: TileSpec):
    """(n_theta_tiles, n_phi_tiles, n_r_tiles) for an (ns, ns, num_r) grid."""
    return _cdiv(ns, spec.t_theta), _cdiv(ns, spec.t_phi), _cdiv(num_r, spec.t_r)


# --- cull + compact ------------------------------------------------------------


def _interval_tile_overlap(lo, hi, axis_vals, tile_size: int, n_tiles: int):
    """(G, n_tiles) bool: does [lo, hi] meet each tile's span of the
    monotonic axis? Padded tiles repeat the last value (degenerate, still
    correct bounds)."""
    pad = n_tiles * tile_size - axis_vals.shape[0]
    av = torch.cat([axis_vals, axis_vals[-1:].expand(pad)])
    tiles = av.reshape(n_tiles, tile_size)
    t_lo = torch.minimum(tiles[:, 0], tiles[:, -1])
    t_hi = torch.maximum(tiles[:, 0], tiles[:, -1])
    return (lo[:, None] <= t_hi[None, :]) & (hi[:, None] >= t_lo[None, :])


def angular_footprints(means, scales, alive, cam, theta, phi, r, spec,
                       scaling_modifier: float = 1.0):
    """Per-Gaussian (d, radius, m_th, m_ph, in_window) footprint geometry of
    both culls (`spec` is a `TileSpec` or an `RSortSpec`); m_th (G, n_tt) /
    m_ph (G, n_pt) mark the tile rows the 3-sigma cull sphere can touch (a
    contiguous interval per axis). Dead Gaussians get radius -1 and empty
    footprints."""
    ns = theta.shape[0]
    n_tt = _cdiv(ns, spec.t_theta)
    n_pt = _cdiv(ns, spec.t_phi)
    pi = torch.pi

    sph = gmath.cartesian_to_spherical(means - cam[None, :])
    d = torch.clamp(sph[:, 0], min=1e-9)
    radius = spec.sigma_cull * scaling_modifier * torch.amax(scales, dim=-1) * spec.margin
    radius = torch.where(alive > 0.5, radius, -1.0)

    alpha = torch.arcsin(torch.clamp(radius / d, -1.0, 1.0))
    th_lo, th_hi = sph[:, 1] - alpha, sph[:, 1] + alpha
    sin_min = torch.clamp(
        torch.minimum(
            torch.sin(torch.clamp(th_lo, 0.0, pi)),
            torch.sin(torch.clamp(th_hi, 0.0, pi)),
        ),
        min=1e-3,
    )
    phi_ratio = radius / (d * sin_min)
    dphi = torch.arcsin(torch.clamp(phi_ratio, -1.0, 1.0))
    ph_lo, ph_hi = sph[:, 2] - dphi, sph[:, 2] + dphi
    # Degenerate footprints cover everything: the sphere contains the scan
    # point, the cone wraps a pole, or the phi window crosses the +-pi seam.
    full_th = (radius >= d) & (radius >= 0.0)
    full_ph = (
        full_th | (phi_ratio >= 1.0) | (ph_lo < -pi) | (ph_hi > pi)
    ) & (radius >= 0.0)

    m_th = _interval_tile_overlap(th_lo, th_hi, theta, spec.t_theta, n_tt) | full_th[:, None]
    m_ph = _interval_tile_overlap(ph_lo, ph_hi, phi, spec.t_phi, n_pt) | full_ph[:, None]
    in_window = (d - radius <= r[-1]) & (d + radius >= r[0]) & (radius >= 0.0)
    return d, radius, m_th, m_ph, in_window


def compact_tiles(mask, k_max: int, topk_fill: bool) -> CompactTiles:
    """(G, T) bool tile membership -> per-tile lists of the members' ids in
    ascending order, truncated at `k_max`.

    One stable sort of each tile's 0/1 key puts its members first in id
    order (the order `lax.top_k` gives ties) and its non-members after them.
    `topk_fill` keeps those non-member ids in the pad slots, as JAX's top_k
    branch does; otherwise pad slots are 0, as its scatter branch writes."""
    g = mask.shape[0]
    raw_counts = mask.sum(dim=0, dtype=torch.int32)
    k_cap = min(k_max, g)
    key = (~mask).T.to(torch.uint8)
    idx = torch.sort(key, dim=1, stable=True).indices[:, :k_cap].to(torch.int32)
    if k_cap < k_max:
        idx = torch.nn.functional.pad(idx, (0, k_max - k_cap))
    counts = torch.clamp(raw_counts, max=k_max)
    slot_valid = torch.arange(k_max, device=mask.device)[None, :] < counts[:, None]
    if not topk_fill:
        idx = torch.where(slot_valid, idx, 0)
    return CompactTiles(
        indices=idx,
        counts=counts,
        slot_valid=slot_valid.to(torch.float32),
        overflowed=torch.any(raw_counts > k_max),
    )


@torch.no_grad()
def cull_tiles(means, scales, alive, cam, theta, phi, r, spec: TileSpec,
               scaling_modifier: float = 1.0) -> CompactTiles:
    """Project the Gaussians' bounding spheres to (theta, phi, r) footprints
    and build the per-tile compact lists. Tiles are ordered
    (r_t, theta_t, phi_t); the cull carries no gradient."""
    ns = theta.shape[0]
    n_tt, n_pt, n_rt = tile_grid_dims(ns, r.shape[0], spec)
    d, radius, m_th, m_ph, _ = angular_footprints(
        means, scales, alive, cam, theta, phi, r, spec, scaling_modifier
    )
    m_r = _interval_tile_overlap(d - radius, d + radius, r, spec.t_r, n_rt)
    mask = (
        m_r[:, :, None, None]
        & m_th[:, None, :, None]
        & m_ph[:, None, None, :]
        & (radius >= 0.0)[:, None, None, None]
    )
    g = means.shape[0]
    n_tiles = n_rt * n_tt * n_pt
    return compact_tiles(mask.reshape(g, n_tiles), spec.k_max,
                         _topk_compaction(g, n_tiles))


# --- tiled sample layout ---------------------------------------------------------


def tile_coords(points, ns: int, num_r: int, spec: TileSpec,
                n_tt: int, n_pt: int, n_rt: int):
    """(num_r, ns, ns, 3) world points -> (T, S, 3) per-tile sample coords,
    tiles (r_t, theta_t, phi_t), samples within a tile (r, theta, phi).
    Padded samples are the origin (zero), as in JAX."""
    pr = n_rt * spec.t_r - num_r
    pt = n_tt * spec.t_theta - ns
    pp = n_pt * spec.t_phi - ns
    pts = torch.nn.functional.pad(points, (0, 0, 0, pp, 0, pt, 0, pr))
    pts = pts.reshape(
        n_rt, spec.t_r, n_tt, spec.t_theta, n_pt, spec.t_phi, 3
    ).permute(0, 2, 4, 1, 3, 5, 6)
    return pts.reshape(n_rt * n_tt * n_pt, spec.t_r * spec.t_theta * spec.t_phi, 3)


def tile_points(points, ns: int, num_r: int, spec: TileSpec,
                n_tt: int, n_pt: int, n_rt: int):
    """(num_r, ns, ns, 3) world points -> (T, S, 10) uncentred monomials."""
    return gmath.point_monomials(tile_coords(points, ns, num_r, spec, n_tt, n_pt, n_rt))


def untile_field(out, ns: int, num_r: int, spec: TileSpec,
                 n_tt: int, n_pt: int, n_rt: int):
    """(T, S, C) tiled field -> (num_r, ns, ns, C)."""
    c = out.shape[-1]
    full = out.reshape(
        n_rt, n_tt, n_pt, spec.t_r, spec.t_theta, spec.t_phi, c
    ).permute(0, 3, 1, 4, 2, 5, 6)
    full = full.reshape(n_rt * spec.t_r, n_tt * spec.t_theta, n_pt * spec.t_phi, c)
    return full[:num_r, :ns, :ns]


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
    samples on the minor axis — the work-list kernels' layout."""
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


# --- gather -----------------------------------------------------------------------


class TakeRows(torch.autograd.Function):
    """`table[idx]` for (T, K) row ids; the backward adds the cotangent rows
    in a fixed order: one `index_add_` a tile, in tile order. A tile's list
    holds distinct ids (`compact_tiles`), and its slots at or past its count
    go to their own sentinel rows past the table (as JAX's unique-scatter
    path does; their cotangents are zero), so no call adds to one row twice
    and each row's sum runs over the tiles in ascending order: the same sum
    on every run, eagerly and from a CUDA graph. One `index_add_` of all
    T*K rows would leave the order of a row's float atomics to the card."""

    @staticmethod
    def forward(ctx, table, idx, counts):
        ctx.save_for_backward(idx, counts)
        ctx.n_rows = table.shape[0]
        return table[idx.long()]

    @staticmethod
    def backward(ctx, grad):
        idx, counts = ctx.saved_tensors
        k = idx.shape[1]
        slot = torch.arange(k, device=idx.device)[None, :]
        dst = torch.where(slot < counts[:, None], idx.long(), ctx.n_rows + slot)
        buf = grad.new_zeros((ctx.n_rows + k,) + tuple(grad.shape[2:]))
        for t in range(idx.shape[0]):
            buf.index_add_(0, dst[t], grad[t])
        return buf[:ctx.n_rows], None, None


def take_rows(table, idx, counts):
    """Differentiable row gather (T, K, ...) = table[idx] of per-tile lists
    with `counts` (T,) valid slots (`TakeRows`)."""
    return TakeRows.apply(table, idx, counts)


# --- K7 / K8: the tile field ------------------------------------------------------

PATCH = 32  # samples a patch: the samples a warp of K7 or K8 tests at once
FWD_CHUNK_BUDGET = 256  # K7: row chunks over all tiles (plus at most one a tile)
FWD_BATCH_ROWS = 256  # K7: rows staged a pass; a chunk holds a multiple of it
BWD_UNIT_ROWS = 256  # K8: rows a unit, one lane a row
SKIP_Q = 175.0  # q at or above which the kernels' exp gives exactly +0
_SKIP_SLACK = 1.0 + 2.0**-16
_SQRT3_UP = 1.7320508075688774  # the double just above sqrt(3)
_INF = float("inf")


class FieldSchedule(NamedTuple):
    """What a K7 / K8 launch builds on the card before it walks samples
    (`_field_fwd_launch`, `_field_bwd_launch`), each equal to its plain
    builder: `units` (`_units_plain`), `rec` on rows below each count
    (`_row_records_plain`), `prec` and `tile_x` (`_patch_records_plain`)."""

    units: torch.Tensor  # (T + 2,) int32: unit offsets, then rows a unit
    rec: torch.Tensor  # (T, K, 8) f32 row records
    prec: torch.Tensor  # (T, n_patches, 4) f32 patch records
    tile_x: torch.Tensor  # (T,) f32: each tile's largest |coordinate|


def quad_form(g, x):
    """<g, x> over the last (10) axis, broadcast over the others, summed in
    index order with one rounding per operation: the order every field
    kernel spells (`quad` in `csrc/common.cuh`), so kernel and plain version
    agree to the last bit before the exp. The forms' terms cancel (~(|x| /
    sigma)^2 uncentred, ~1e4 times the value tile-centred at a 1 m radial
    tile); a matmul's summation order alone would move single samples' pdf
    by percent at sigma 2 mm."""
    m = g[..., 0] * x[..., 0]
    for f in range(1, FDIM):
        m = m + g[..., f] * x[..., f]
    return m


def _field_args(xfeat, gfeat, weights, counts):
    t, a, fdim = xfeat.shape
    k = gfeat.shape[1]
    c = weights.shape[2]
    if fdim != FDIM or not 1 <= c <= 2:
        raise ValueError(f"xfeat {tuple(xfeat.shape)} / {c} channels not supported")
    check_tensor(xfeat, "xfeat", torch.float32)
    check_tensor(gfeat, "gfeat", torch.float32, (t, k, FDIM))
    check_tensor(weights, "weights", torch.float32, (t, k, c))
    check_tensor(counts, "counts", torch.int32, (t,))
    for name, v in (("xfeat", xfeat), ("gfeat", gfeat)):
        if v.data_ptr() % 16:  # the kernels copy rows 8 bytes at a time
            raise ValueError(f"{name} must start on a 16-byte boundary")
    return t, a, k, c


def patch_dims(a: int, tile_shape=None):
    """((tr, tt, tp), patches a tile) of the kernels' patch map. A patch is
    8 r x 2 theta x 2 phi samples of a (t_r, t_theta, t_phi) tile (samples
    in (r, theta, phi) order) where such patches tile it; otherwise, or
    without `tile_shape`, 32 consecutive samples, the last one short where
    32 does not divide `a`: then (0, 0, 0)."""
    if tile_shape is not None:
        tr, tt, tp = tile_shape
        if tr % 8 == 0 and tt % 2 == 0 and tp % 2 == 0 and tr * tt * tp == a:
            return (tr, tt, tp), a // PATCH
    return (0, 0, 0), _cdiv(a, PATCH)


def patch_samples(a: int, tile_shape=None, device=None):
    """(patches, 32) int64: the tile sample of each (patch, lane), -1 past
    `a` (`patch_sample` in `csrc/common.cuh`)."""
    (tr, tt, tp), n_p = patch_dims(a, tile_shape)
    p = torch.arange(n_p, device=device)[:, None]
    j = torch.arange(PATCH, device=device)[None, :]
    if tr == 0:
        s = p * PATCH + j
        return torch.where(s < a, s, -1)
    npt, npp = tt // 2, tp // 2
    r = (p // (npt * npp)) * 8 + j // 4
    th = ((p // npp) % npt) * 2 + (j // 2) % 2
    ph = (p % npp) * 2 + j % 2
    return (r * tt + th) * tp + ph


def _round_up_f32(v):
    """float64 -> the least float32 >= it (`__double2float_ru`)."""
    f = v.float()
    return torch.where(f.double() < v, torch.nextafter(f, torch.full_like(f, _INF)), f)


def _patch_records_plain(xfeat, tile_shape=None, go=None):
    """(prec (T, patches, 4), tile_x (T,)) f32 (`patch_records`): each
    patch's box centre xc and rho >= the largest |x - xc| (rounded up from
    float64), rho = inf where a sample is not finite, its quadratic
    monomials are not the f32 products of its coordinates or its constant
    is not 1 (or, given `go`, a cotangent is not finite): such a patch is
    never skipped. tile_x: the largest |coordinate| of the tile's valid
    patches (0 if none)."""
    smp = patch_samples(xfeat.shape[1], tile_shape, xfeat.device)
    has = smp >= 0
    v = xfeat[:, smp.clamp(min=0)]  # (T, patches, 32, 10)
    x, y, z = v[..., 6], v[..., 7], v[..., 8]
    ok = (torch.isfinite(v).all(-1) & (v[..., 0] == x * x) & (v[..., 1] == y * y)
          & (v[..., 2] == z * z) & (v[..., 3] == x * y) & (v[..., 4] == x * z)
          & (v[..., 5] == y * z) & (v[..., 9] == 1.0))
    if go is not None:
        ok &= torch.isfinite(go[:, smp.clamp(min=0)]).all(-1)
    valid = (ok | ~has).all(-1)
    coords = v[..., 6:9]
    use = has[..., None] & ~torch.isnan(coords)  # fminf / fmaxf skip NaN
    lo = torch.where(use, coords, _INF).amin(2)
    hi = torch.where(use, coords, -_INF).amax(2)
    xc = (lo + hi) * 0.5
    dd = coords.double() - xc.double()[:, :, None]
    r2 = (dd[..., 0] * dd[..., 0] + dd[..., 1] * dd[..., 1]) + dd[..., 2] * dd[..., 2]
    r2 = torch.where(has, r2, 0.0).amax(-1)
    rho = torch.where(valid, _round_up_f32(torch.sqrt(r2)), _INF)
    big = torch.maximum(lo.abs(), hi.abs()).amax(-1)
    tile_x = torch.where(valid, big, 0.0).amax(-1)
    return torch.cat([xc, rho[..., None]], -1), tile_x


def _row_records_plain(gfeat, weights, counts, tile_x):
    """(T, K, 8) f32 row records (`row_record` in `csrc/common.cuh`, the
    same float64 operations in the same order): [mu_f, R1, sl, R2, G2, 0].
    A row at or past its tile's count, with a non-finite form or weight,
    or whose form is not provably positive definite gets R1 = R2 = inf:
    never skipped."""
    d = gfeat.double()
    big = tile_x.double()[:, None]
    a00, a11, a22 = d[..., 0], d[..., 1], d[..., 2]
    a01, a02, a12 = 0.5 * d[..., 3], 0.5 * d[..., 4], 0.5 * d[..., 5]
    b0, b1, b2, cc = d[..., 6], d[..., 7], d[..., 8], d[..., 9]
    c00 = a11 * a22 - a12 * a12
    c01 = a02 * a12 - a01 * a22
    c02 = a01 * a12 - a11 * a02
    c11 = a00 * a22 - a02 * a02
    c12 = a01 * a02 - a00 * a12
    c22 = a00 * a11 - a01 * a01
    det = (a00 * c00 + a01 * c01) + a02 * c02
    m2 = (c00 + c11) + c22
    tr = (a00 + a11) + a22
    e_det = 2.0**-48 * ((a00.abs() * ((a11 * a22).abs() + a12 * a12)
                         + a01.abs() * ((a02 * a12).abs() + (a01 * a22).abs()))
                        + a02.abs() * ((a01 * a12).abs() + (a11 * a02).abs()))
    e_m2 = 2.0**-48 * ((((a11 * a22).abs() + a12 * a12) + ((a00 * a22).abs() + a02 * a02))
                       + ((a00 * a11).abs() + a01 * a01))
    e_tr = 2.0**-48 * ((a00.abs() + a11.abs()) + a22.abs())
    r0, r1, r2 = a01.abs() + a02.abs(), a01.abs() + a12.abs(), a02.abs() + a12.abs()
    g_lo = torch.minimum(torch.minimum(a00 - r0, a11 - r1), a22 - r2)
    g_hi = torch.maximum(torch.maximum(a00 + r0, a11 + r1), a22 + r2)
    minors = (tr - e_tr > 0) & (m2 - e_m2 > 0) & (det - e_det > 0)
    lb_det = torch.where(minors, (det - e_det) / (m2 + e_m2), 0.0)
    lmin = torch.maximum(lb_det, g_lo - 2.0**-48 * g_hi) * (1.0 - 2.0**-40)
    lmax = torch.minimum(tr, g_hi) * (1.0 + 2.0**-40)
    inv = -0.5 / det
    mu0 = ((c00 * b0 + c01 * b1) + c02 * b2) * inv
    mu1 = ((c01 * b0 + c11 * b1) + c12 * b2) * inv
    mu2 = ((c02 * b0 + c12 * b1) + c22 * b2) * inv
    am0 = (a00 * mu0 + a01 * mu1) + a02 * mu2
    am1 = (a01 * mu0 + a11 * mu1) + a12 * mu2
    am2 = (a02 * mu0 + a12 * mu1) + a22 * mu2
    q0, q1, q2 = b0 + 2.0 * am0, b1 + 2.0 * am1, b2 + 2.0 * am2
    rn = torch.sqrt((q0 * q0 + q1 * q1) + q2 * q2)
    s_mu = (cc + ((b0 * mu0 + b1 * mu1) + b2 * mu2)) + ((mu0 * am0 + mu1 * am1) + mu2 * am2)
    mun = torch.sqrt((mu0 * mu0 + mu1 * mu1) + mu2 * mu2)
    y = torch.maximum(big, torch.maximum(torch.maximum(mu0.abs(), mu1.abs()), mu2.abs()))
    ga = d.abs()
    g2 = ga[..., 0]
    for f in range(1, 6):
        g2 = g2 + ga[..., f]
    g1 = (ga[..., 6] + ga[..., 7]) + ga[..., 8]
    bnd = ((g2 * y) * y + g1 * y) + cc.abs()
    thr = ((SKIP_Q + 2.0**-19 * bnd) + rn * (_SQRT3_UP * big + mun)) - s_mu
    thr = torch.clamp(thr, min=0.0)
    mu = torch.stack([mu0, mu1, mu2], -1)
    mu_f = mu.float()
    e = mu_f.double() - mu
    e_mu = torch.sqrt((e[..., 0] * e[..., 0] + e[..., 1] * e[..., 1]) + e[..., 2] * e[..., 2])
    sl = torch.sqrt(lmax)
    r_1 = _round_up_f32(torch.sqrt(thr / lmin) + e_mu)
    r_2 = _round_up_f32(torch.sqrt(thr) + sl * e_mu)
    rec = torch.cat([mu_f, r_1[..., None], _round_up_f32(sl)[..., None], r_2[..., None],
                     _round_up_f32(g2)[..., None], torch.zeros_like(r_1)[..., None]], -1)
    listed = torch.arange(gfeat.shape[1], device=gfeat.device)[None, :] < counts[:, None]
    ok = (listed & torch.isfinite(gfeat).all(-1) & torch.isfinite(weights).all(-1)
          & (lmin > 0))
    never = torch.tensor([0.0, 0.0, 0.0, _INF, 0.0, _INF, 0.0, 0.0], device=rec.device)
    return torch.where(ok[..., None], rec, never)


def _skip_plain(rec, g, prec):
    """Whether a row (record `rec` (..., 8), form `g` (..., 10)) may skip a
    patch (`prec` (..., 4)), broadcast (`skip_pair` in `csrc/common.cuh`,
    the same f32 operations): True only where q >= SKIP_Q at every sample of
    the patch, so the kernels' p is exactly +0 there."""
    dx, dy, dz = (prec[..., i] - rec[..., i] for i in range(3))
    xx, yy, zz = dx * dx, dy * dy, dz * dz
    d2 = (xx + yy) + zz
    t1 = prec[..., 3] + rec[..., 3]
    far = d2 > (t1 * t1) * _SKIP_SLACK
    n2 = g[..., 0] * xx + g[..., 1] * yy
    n2 = n2 + g[..., 2] * zz
    n2 = n2 + g[..., 3] * (dx * dy)
    n2 = n2 + g[..., 4] * (dx * dz)
    n2 = n2 + g[..., 5] * (dy * dz)
    n2lb = n2 - (rec[..., 6] * 2.0**-16) * d2
    t2 = rec[..., 4] * prec[..., 3] + rec[..., 5]
    return far | (n2lb > (t2 * t2) * _SKIP_SLACK)


def _units_plain(counts, k: int, rows: int | None = None,
                 budget: int = FWD_CHUNK_BUDGET, quantum: int = FWD_BATCH_ROWS):
    """(T + 2,) int32 (`field_units` in `csrc/common.cuh`): the exclusive
    scan of each tile's units ceil(min(count, k) / R) over the tiles, the
    total, then R: `rows` (K8: BWD_UNIT_ROWS), or for K7 the least multiple
    of `quantum` that keeps sum_t min(count, k) / R <= `budget`."""
    n = counts.long().clamp(0, k)
    if rows is None:
        per = -(-int(n.sum()) // budget)
        rows = max(quantum, -(-per // quantum) * quantum)
    cnt = -(-n // rows)
    off = torch.cat([torch.zeros(1, dtype=torch.int64, device=counts.device), cnt.cumsum(0)])
    return torch.cat([off, off.new_tensor([rows])]).to(torch.int32)


def field_fwd(xfeat, gfeat, weights, counts, tile_shape=None):
    """Tile field forward (K7): (T, A, C) f32 with

        out[t, a, c] = sum_{k < counts[t]} weights[t, k, c]
                       * exp(-1/2 * max(<xfeat[t, a], gfeat[t, k]>, 0)).

    xfeat (T, A, 10) monomials; gfeat (T, K, 10) forms and weights (T, K, C)
    per-tile lists; counts (T,) int32. Rows at or past a tile's count are
    never read. A tile with count 0 gives zeros. `tile_shape` (t_r,
    t_theta, t_phi), the sample order of a tile, only picks the kernel's
    sample patches (`patch_dims`); the function does not depend on it."""
    if on_cpu(xfeat, gfeat, weights, counts):
        return _field_fwd_plain(xfeat, gfeat, weights, counts)
    return _field_fwd_launch(xfeat, gfeat, weights, counts, tile_shape)[0]


def _field_fwd_launch(xfeat, gfeat, weights, counts, tile_shape=None):
    """K7 on CUDA tensors: (out, FieldSchedule)."""
    t, a, k, c = _field_args(xfeat, gfeat, weights, counts)
    (tr, tt, tp), n_p = patch_dims(a, tile_shape)
    f32 = dict(dtype=torch.float32, device=xfeat.device)
    out = torch.empty((t, a, c), **f32)
    sched = FieldSchedule(
        units=torch.empty(t + 2, dtype=torch.int32, device=xfeat.device),
        rec=torch.empty((t, k, 8), **f32), prec=torch.empty((t, n_p, 4), **f32),
        tile_x=torch.empty(t, **f32))
    # Partials of the chunks: at most FWD_CHUNK_BUDGET + T, whatever k_max is.
    partial = torch.empty((FWD_CHUNK_BUDGET + t, n_p * PATCH, c), **f32)
    KERNELS["field_fwd"].launch(
        ptr(xfeat), ptr(gfeat), ptr(weights), ptr(counts), ptr(out), ptr(sched.prec),
        ptr(sched.tile_x), ptr(sched.rec), ptr(sched.units), ptr(partial), t, a, k, c,
        tr, tt, tp, FWD_CHUNK_BUDGET, FWD_BATCH_ROWS)
    return out, sched


def field_bwd(xfeat, gfeat, weights, counts, go, tile_shape=None):
    """Tile field backward (K8): (dg (T, K, 10), dw (T, K, C)) f32 with, for
    rows k < counts[t] and p = exp(-1/2 max(m, 0)), m = <x[t, a], g[t, k]>,

        dw[t, k, c] = sum_a p * go[t, a, c],
        dg[t, k, :] = sum_a [m > 0] * (-1/2 p sum_c go[t, a, c] w[t, k, c]) * x[t, a, :],

    and exactly zero on rows at or past the count. (The TPU kernel leaves
    dw = sum p go in the pad rows of a partial 256-row block; the caller's
    `slot_valid` mask zeroes those either way.) `tile_shape` as for
    `field_fwd`."""
    if on_cpu(xfeat, gfeat, weights, counts, go):
        return _field_bwd_plain(xfeat, gfeat, weights, counts, go)
    return _field_bwd_launch(xfeat, gfeat, weights, counts, go, tile_shape)[0]


def _field_bwd_launch(xfeat, gfeat, weights, counts, go, tile_shape=None):
    """K8 on CUDA tensors: ((dg, dw), FieldSchedule)."""
    t, a, k, c = _field_args(xfeat, gfeat, weights, counts)
    check_tensor(go, "go", torch.float32, (t, a, c))
    (tr, tt, tp), n_p = patch_dims(a, tile_shape)
    f32 = dict(dtype=torch.float32, device=xfeat.device)
    dg = torch.empty_like(gfeat)
    dw = torch.empty_like(weights)
    sched = FieldSchedule(
        units=torch.empty(t + 2, dtype=torch.int32, device=xfeat.device),
        rec=torch.empty((t, k, 8), **f32), prec=torch.empty((t, n_p, 4), **f32),
        tile_x=torch.empty(t, **f32))
    KERNELS["field_bwd"].launch(
        ptr(xfeat), ptr(gfeat), ptr(weights), ptr(counts), ptr(go), ptr(dg), ptr(dw),
        ptr(sched.prec), ptr(sched.tile_x), ptr(sched.rec), ptr(sched.units), t, a, k, c,
        tr, tt, tp, BWD_UNIT_ROWS)
    return (dg, dw), sched


_PLAIN_CHUNK_ELEMENTS = 1 << 24  # per (A, rows) temporary: 64 MiB


def _row_chunks(n: int, a: int):
    step = max(1, _PLAIN_CHUNK_ELEMENTS // max(a, 1))
    return [(k0, min(k0 + step, n)) for k0 in range(0, n, step)]


def _field_fwd_plain(xfeat, gfeat, weights, counts):
    t, a, _ = xfeat.shape
    out = xfeat.new_zeros((t, a, weights.shape[2]))
    for ti, n in enumerate(counts.tolist()):
        for k0, k1 in _row_chunks(min(n, gfeat.shape[1]), a):
            m = quad_form(gfeat[ti, None, k0:k1], xfeat[ti, :, None])
            out[ti] += torch.exp(-0.5 * torch.clamp(m, min=0.0)) @ weights[ti, k0:k1]
    return out


def _field_bwd_plain(xfeat, gfeat, weights, counts, go):
    a = xfeat.shape[1]
    c = weights.shape[2]
    dg = torch.zeros_like(gfeat)
    dw = torch.zeros_like(weights)
    for ti, n in enumerate(counts.tolist()):
        x, g_t = xfeat[ti], go[ti]
        for k0, k1 in _row_chunks(min(n, gfeat.shape[1]), a):
            m = quad_form(gfeat[ti, None, k0:k1], x[:, None])
            p = torch.exp(-0.5 * torch.clamp(m, min=0.0))
            w = weights[ti, k0:k1]
            dw[ti, k0:k1] = p.T @ g_t
            wg = g_t[:, 0:1] * w[None, :, 0]
            for ci in range(1, c):
                wg = wg + g_t[:, ci:ci + 1] * w[None, :, ci]
            dm = torch.where(m > 0.0, -0.5 * p * wg, 0.0)
            dg[ti, k0:k1] = dm.T @ x
    return dg, dw


class FusedField(torch.autograd.Function):
    """`field_fwd` with the `field_bwd` backward. `xfeat` and `counts` get no
    gradient (stop-gradient geometry, integral counts), as in JAX."""

    @staticmethod
    def forward(ctx, xfeat, gfeat, weights, counts, tile_shape):
        ctx.save_for_backward(xfeat, gfeat, weights, counts)
        ctx.tile_shape = tile_shape
        return field_fwd(xfeat, gfeat, weights, counts, tile_shape)

    @staticmethod
    def backward(ctx, go):
        xfeat, gfeat, weights, counts = ctx.saved_tensors
        dg, dw = field_bwd(xfeat, gfeat, weights, counts, go.contiguous(), ctx.tile_shape)
        return None, dg, dw, None, None


def fused_field(xfeat, gfeat, weights, counts, tile_shape=None):
    """out[t, a, c] = sum_{k < counts[t]} weights[t, k, c] *
    exp(-1/2 max(<xfeat[t, a], gfeat[t, k]>, 0)), differentiable in gfeat
    and weights (`FusedField`); `tile_shape` as for `field_fwd`."""
    return FusedField.apply(xfeat, gfeat, weights, counts, tile_shape)


def fused_gaussian_field(gfeat, channel_weights, points, tiles: CompactTiles,
                         spec: TileSpec):
    """sum_g w_gc * pdf_g at every shell sample, tile-sparsely.

    gfeat (G, 10), channel_weights (G, C), points (num_r, ns, ns, 3) (no
    gradient). One combined [gfeat | w] gather, `w` masked by `slot_valid`,
    the fused field, then the untiling. Returns ((num_r, ns, ns, C) field,
    overflow flag)."""
    num_r, ns = points.shape[0], points.shape[1]
    n_tt, n_pt, n_rt = tile_grid_dims(ns, num_r, spec)
    with torch.no_grad():
        xfeat = tile_points(points, ns, num_r, spec, n_tt, n_pt, n_rt).contiguous()
    gw = torch.cat([gfeat, channel_weights], dim=1)
    gw_tiles = take_rows(gw, tiles.indices, tiles.counts)
    g_tiles = gw_tiles[..., :FDIM].contiguous()
    w_tiles = (gw_tiles[..., FDIM:] * tiles.slot_valid[..., None]).contiguous()
    out = fused_field(xfeat, g_tiles, w_tiles, tiles.counts,
                      (spec.t_r, spec.t_theta, spec.t_phi))
    return untile_field(out, ns, num_r, spec, n_tt, n_pt, n_rt), tiles.overflowed
