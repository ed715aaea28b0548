"""Work-list-scheduled closed-form (erf section) field ('pallas_analytic').

Port of `nlos_gaussian_renderer_tpu/ops/fused_analytic.py`. The cull,
layout, wide gather and K1/K2 work lists of `ops/fused_rsort.py` are reused
unchanged; only the field differs. Per work item and for each ray s of the
angular tile and row k of the block, the ray's squared Mahalanobis is
    m(s) = qa s^2 + qb s + qc,  s = t - t_c,
in the ray parameterisation y(s) = u + s w around the point of the ray
nearest the tile centroid x0 (u = cam - x0 + t_c w), and every bin of the
item's range [bl, bh] gets its exact optical depth
    tau = pref * (erf(z1) - erf(z0)),
    pref = sqrt(2 pi)/2 * qa^-1/2 * exp(-phi/2),  phi = max(qc - qb^2/(4qa), 0),
    z(e) = sqrt(qa/2) * (e - t_c + qb/(2qa)).
(qa, qb, qc) are the row's form centred at x0 (`_center_transform`)
contracted with the ray's three 10-row feature blocks of the quad slab:
mon2(w), the qb features and mon(u). The backward uses the closed-form
moments I1, I2 of exp(-m/2) over each bin (see `csrc/analytic_bwd.cu`).

Kernel K5 (`analytic_fwd`) and K6 (`analytic_bwd`) launch for CUDA tensors
and raise on anything they cannot take; for CPU tensors the plain PyTorch
versions beside them run. Both split the work lists into units built on
the card, as K3 and K4 do (`fused_rsort.py`): K5 a (group of at most
`AN_FWD_GROUP_ITEMS` items of one tile, slab of `AN_FWD_SLAB_BINS` bins)
pair, K6 at most `AN_BWD_UNIT_BINS` bins of one backward item. Not carried
over, because they exist for Mosaic and the MXU: the polynomial erf (the
port uses the native one), the bf16x3 contractions and `bwd_p_bf16` (the
port computes in f32 and ignores the flag), the gate ladder (the port
covers exactly each item's [bl, bh]), the 16-row sublane padding of the
slab, and the `first`-flag zero init (the kernels write every output).
"""

from __future__ import annotations

import math

import torch

from nlos_gaussian_renderer_tpu_torch.ops.analytic import bin_edges_from_grid
from nlos_gaussian_renderer_tpu_torch.ops.cuda_build import (
    KERNELS,
    check_tensor,
    on_cpu,
    ptr,
)
from nlos_gaussian_renderer_tpu_torch.ops.fused import (
    FDIM,
    TileSpec,
    _pad_axis,
    _tile_points_centered_direct_pts,
    quad_form,
    untile_field_t,
)
from nlos_gaussian_renderer_tpu_torch.ops.fused_rsort import (
    RSortGeometry,
    RSortSpec,
    RSortTiles,
    _cdiv,
    _center_transform,
    _center_transform_t,
    _field_table,
    _item_batches,
    _member_of,
    _rect_bits,
    bwd_unit_capacity,
    fwd_group_capacity,
)

QDIM = 3 * FDIM  # quad slab rows: qa | qb | qc feature blocks
_HALF_SQRT_2PI = 0.5 * math.sqrt(2.0 * math.pi)
_SQRT_HALF = math.sqrt(0.5)


def _tile_counts(ns: int, num_r: int, spec: RSortSpec):
    return _cdiv(ns, spec.t_theta), _cdiv(ns, spec.t_phi), _cdiv(num_r, spec.t_chunk)


def analytic_tile_aux(theta, phi, r, cam, spec: RSortSpec):
    """(T_tot, 4) per-(chunk, tile) [delta (3), t_c]: delta = cam - x0 with
    x0 the tile's sample centroid, t_c = |delta|.

    The JAX version takes the grid points and zero-pads partial tiles; the
    centroids here come from `fused._tile_points_centered_direct_pts`, which
    extends a padded axis by its grid step. Unpadded tiles get the same
    centroid; a padded tile's anchor moves, which leaves the field exact
    (the centring is exact for any anchor)."""
    n_tt, n_pt, n_ch = _tile_counts(theta.shape[0], r.shape[0], spec)
    tp = TileSpec(t_theta=spec.t_theta, t_phi=spec.t_phi, t_r=spec.t_chunk)
    _, centers = _tile_points_centered_direct_pts(theta, phi, r, cam, tp,
                                                  n_tt, n_pt, n_ch)
    delta = cam[None, :] - centers
    t_c = torch.linalg.vector_norm(delta, dim=-1, keepdim=True)
    return torch.cat([delta, t_c], dim=1)


def analytic_quad_slabs(theta, phi, aux4, spec: RSortSpec, n_ch: int):
    """(T_tot, 30, S_ang) per-(chunk, tile) ray features: rows 0-9 mon2(w)
    (6, then zeros) give qa, rows 10-19 the qb features
    [2 u_i w_i (3), u_i w_j + u_j w_i (3), w (3), 0] and rows 20-29 mon(u)
    give qc, with u = delta + t_c w. Rays are in the tile's
    (theta_local, phi_local) order; a padded axis is extended by its step."""
    ns = theta.shape[0]
    n_tt, n_pt = _cdiv(ns, spec.t_theta), _cdiv(ns, spec.t_phi)
    t_ang, s_ang = n_tt * n_pt, spec.t_theta * spec.t_phi
    th = _pad_axis(theta, spec.t_theta, n_tt)
    ph = _pad_axis(phi, spec.t_phi, n_pt)
    sin_t = torch.sin(th)[:, None, :, None]
    cos_t = torch.cos(th)[:, None, :, None]
    cos_p = torch.cos(ph)[None, :, None, :]
    sin_p = torch.sin(ph)[None, :, None, :]
    w = torch.stack(
        [sin_t * cos_p, sin_t * sin_p,
         cos_t.expand(n_tt, n_pt, spec.t_theta, spec.t_phi)],
        dim=-1,
    ).reshape(t_ang, s_ang, 3)
    w0, w1, w2 = w.unbind(-1)  # (T_ang, S)
    zero = torch.zeros_like(w0)
    mon2_w = torch.stack(
        [w0 * w0, w1 * w1, w2 * w2, w0 * w1, w0 * w2, w1 * w2,
         zero, zero, zero, zero],
        dim=1,
    )  # (T_ang, 10, S)
    d = aux4[:, :3].reshape(n_ch, t_ang, 1, 3)
    tc = aux4[:, 3].reshape(n_ch, t_ang, 1, 1)
    u0, u1, u2 = (d + tc * w[None]).unbind(-1)  # (n_ch, T_ang, S)
    wb0, wb1, wb2 = w0[None], w1[None], w2[None]
    zb = torch.zeros_like(u0)
    qb_feats = torch.stack(
        [2.0 * u0 * wb0, 2.0 * u1 * wb1, 2.0 * u2 * wb2,
         u0 * wb1 + u1 * wb0, u0 * wb2 + u2 * wb0, u1 * wb2 + u2 * wb1,
         wb0 + zb, wb1 + zb, wb2 + zb, zb],
        dim=2,
    )
    mon_u = torch.stack(
        [u0 * u0, u1 * u1, u2 * u2, u0 * u1, u0 * u2, u1 * u2,
         u0, u1, u2, torch.ones_like(u0)],
        dim=2,
    )
    slab = torch.cat([mon2_w[None].expand_as(mon_u), qb_feats, mon_u], dim=2)
    return slab.reshape(n_ch * t_ang, QDIM, s_ang)


def chunk_edges(r, spec: RSortSpec):
    """(n_ch, t_chunk + 1) absolute bin edges per radial chunk; a padded
    last chunk continues the edges by the grid step."""
    num_r = r.shape[0]
    n_ch = _cdiv(num_r, spec.t_chunk)
    dr = r[1] - r[0]
    pad = n_ch * spec.t_chunk - num_r
    edges = bin_edges_from_grid(r)
    if pad:
        ar = torch.arange(1, pad + 1, dtype=r.dtype, device=r.device)
        edges = torch.cat([edges, edges[-1] + dr * ar])
    idx = (
        torch.arange(n_ch, device=r.device)[:, None] * spec.t_chunk
        + torch.arange(spec.t_chunk + 1, device=r.device)[None, :]
    )
    return edges[idx]


def analytic_operands(grid, cam, spec: RSortSpec):
    """The kernels' per-render operands: slab (T_tot, 30, S_ang), aux
    (T_tot, 8) [delta (3), t_c, x0 (3), 0] and edges (n_ch, t_chunk + 1)."""
    n_ch = _cdiv(grid.r.shape[0], spec.t_chunk)
    aux4 = analytic_tile_aux(grid.theta, grid.phi, grid.r, cam, spec)
    slab = analytic_quad_slabs(grid.theta, grid.phi, aux4, spec, n_ch)
    x0 = cam[None, :] - aux4[:, :3]
    aux = torch.cat([aux4, x0, torch.zeros_like(x0[:, :1])], dim=1)
    return slab.contiguous(), aux.contiguous(), chunk_edges(grid.r, spec).contiguous()


# K5 / K6 ----------------------------------------------------------------------


def _an_args(slab, aux, edges, table, words, lists, n_items, geo: RSortGeometry, c):
    t_tot, qdim, s_ang = slab.shape
    if qdim != QDIM or s_ang != geo.s_ang:
        raise ValueError(f"slab shape {tuple(slab.shape)} does not match {geo}")
    if t_tot != geo.t_ang * geo.n_ch:
        raise ValueError(f"{t_tot} tiles, expected {geo.t_ang * geo.n_ch}")
    rows, f = table.shape
    if rows % geo.g_tile or words.shape[0] != rows:
        raise ValueError("table/words rows must be whole g_tile blocks")
    if not 1 <= c <= 2 or f < FDIM + c:
        raise ValueError(f"channel count {c} with table width {f}")
    check_tensor(slab, "slab", torch.float32)
    check_tensor(aux, "aux", torch.float32, (t_tot, 8))
    check_tensor(edges, "edges", torch.float32, (geo.n_ch, geo.t_chunk + 1))
    check_tensor(table, "table", torch.float32)
    check_tensor(words, "words", torch.int32)
    check_tensor(lists, "work list", torch.int32)
    check_tensor(n_items, "n_items", torch.int32, (1,))
    b_t, b_p, _ = _rect_bits(geo.n_tt, geo.n_pt)
    return (t_tot, s_ang, geo.t_ang, geo.n_ch, geo.t_chunk, geo.g_tile, f, c,
            lists.shape[1], geo.n_pt, b_t, b_p)


# The unit sizes of K5 and K6: the fastest of a sweep at the bench scene on
# an H100 (PERF.md). The kernels are built for these widths and refuse others.
AN_FWD_GROUP_ITEMS = 1  # K5: at most this many items of one tile per unit
AN_FWD_SLAB_BINS = 8  # K5: bins a unit (slab), from its group's first bin
AN_BWD_UNIT_BINS = 16  # K6: at most this many bins of one item per unit


def analytic_fwd(slab, aux, edges, table, words, fwd, n_items,
                 geo: RSortGeometry, c: int):
    """Forward optical depths over the forward work list: (T_tot, C,
    t_chunk * S_ang) f32, sample b * S_ang + s for bin b and ray s,

        out[tile, c, b*S + s] = sum over the tile's items with b in [bl, bh],
                                of sum_k w_c[k] * member[k] * tau_k(b, s).

    slab (T_tot, 30, S_ang) from `analytic_quad_slabs`; aux (T_tot, 8)
    [delta, t_c, x0, 0]; edges (n_ch, t_chunk + 1); table (KB*g_tile, F)
    rows [forms | weights (c) | ...]; words (KB*g_tile,) int32; fwd (6, W).
    Tiles with no items are zero."""
    if on_cpu(slab, aux, edges, table, words, fwd, n_items):
        return _analytic_fwd_plain(slab, aux, edges, table, words, fwd, n_items, geo, c)
    return _analytic_fwd_launch(slab, aux, edges, table, words, fwd, n_items, geo, c)[0]


def _analytic_fwd_launch(slab, aux, edges, table, words, fwd, n_items, geo, c):
    """K5 on CUDA tensors: (out, schedule). The schedule is the (6, G + 1)
    int32 array of `_fwd_groups_plain(..., AN_FWD_GROUP_ITEMS,
    AN_FWD_SLAB_BINS)` as the kernel built it. Scratch: the centred rows,
    W * g_tile * 48 bytes (7.9 MB at the bench scene: W 644, g_tile 256),
    and the partial fields, G * ceil(t_chunk / U) units of C * U * S_ang
    floats (I 1, U 8: 652 * 25 units, 67 MB at C = 1, of which the 1,449
    live units touch 5.9 MB)."""
    args = _an_args(slab, aux, edges, table, words, fwd, n_items, geo, c)
    w = fwd.shape[1]
    g_cap = fwd_group_capacity(w, slab.shape[0], AN_FWD_GROUP_ITEMS)
    n_units = g_cap * _cdiv(geo.t_chunk, AN_FWD_SLAB_BINS)
    f32 = dict(dtype=torch.float32, device=slab.device)
    out = torch.empty((slab.shape[0], c, geo.s_ang * geo.t_chunk), **f32)
    # The schedule, then the unit -> group map.
    sched = torch.empty(6 * (g_cap + 1) + n_units, dtype=torch.int32, device=slab.device)
    rows = torch.empty((w, geo.g_tile, 12), **f32)
    partial = torch.empty((n_units, c, AN_FWD_SLAB_BINS, geo.s_ang), **f32)
    KERNELS["analytic_fwd"].launch(
        ptr(slab), ptr(aux), ptr(edges), ptr(table), ptr(words), ptr(fwd),
        ptr(n_items), ptr(out), ptr(sched), ptr(rows), ptr(partial), *args,
        AN_FWD_GROUP_ITEMS, AN_FWD_SLAB_BINS, g_cap, geo.t_phi,
    )
    return out, sched[:6 * (g_cap + 1)].reshape(6, g_cap + 1)


def analytic_bwd(slab, aux, edges, table, words, bwd, n_items, go,
                 geo: RSortGeometry, c: int):
    """Cotangent of `analytic_fwd` with respect to the table: (KB*g_tile, F)
    f32, nonzero only in the form and weight columns of member rows, by the
    closed-form moments over each item's bins [bl, bh]. Like the TPU kernel
    it ignores the qa and phi clamps of the forward."""
    if on_cpu(slab, aux, edges, table, words, bwd, n_items, go):
        return _analytic_bwd_plain(slab, aux, edges, table, words, bwd, n_items, go,
                                   geo, c)
    return _analytic_bwd_launch(slab, aux, edges, table, words, bwd, n_items, go,
                                geo, c)[0]


def _analytic_bwd_launch(slab, aux, edges, table, words, bwd, n_items, go, geo, c):
    """K6 on CUDA tensors: (dtable, unit offsets). The offsets are the (W +
    1,) int32 array of `_bwd_unit_offsets_plain(..., AN_BWD_UNIT_BINS)` as
    the kernel built it. The partial scratch is W * ceil(t_chunk / U) * (10 +
    C) * g_tile floats, taken from the caching allocator on every call: at
    the bench scene (W 644, U 16: 8,372 units) 94 MB at C = 1, of which the
    914 live units touch 10 MB; it grows with W as K4's
    (`_rsort_bwd_launch`)."""
    args = _an_args(slab, aux, edges, table, words, bwd, n_items, geo, c)
    check_tensor(go, "go", torch.float32, (slab.shape[0], c, geo.s_ang * geo.t_chunk))
    w = bwd.shape[1]
    cap = bwd_unit_capacity(w, geo.t_chunk, AN_BWD_UNIT_BINS)
    dtable = torch.empty_like(table)
    # Unit offsets, then the unit -> item map.
    units = torch.empty(w + 1 + cap, dtype=torch.int32, device=table.device)
    partial = torch.empty((cap, FDIM + c, geo.g_tile), dtype=torch.float32,
                          device=table.device)
    KERNELS["analytic_bwd"].launch(
        ptr(slab), ptr(aux), ptr(edges), ptr(table), ptr(words), ptr(bwd),
        ptr(n_items), ptr(go), ptr(dtable), ptr(units), ptr(partial), *args,
        table.shape[0] // geo.g_tile, AN_BWD_UNIT_BINS, cap,
    )
    return dtable, units[:w + 1]


def _section_terms(qa, qb, qc):
    """(inv_qa, qb/2, qb/(2qa), exp(-phi/2), pref, sqrt(qa/2)), in the order
    the kernels spell with correctly rounded operations (`section_head` and
    `section_tail` in `csrc/common.cuh`), so both agree to the last bit
    before the exp."""
    qa = torch.clamp(qa, min=1e-8)
    inv_qa = torch.reciprocal(qa)
    sq = torch.sqrt(qa)
    half_qb = 0.5 * qb
    shift = half_qb * inv_qa
    phi = torch.clamp(qc - half_qb * shift, min=0.0)
    eh = torch.exp(-0.5 * phi)
    pref = (_HALF_SQRT_2PI / sq) * eh
    return inv_qa, half_qb, shift, eh, pref, sq * _SQRT_HALF


def _an_items(slab, aux, edges, table, words, lists, i0, i1, geo, c):
    """Per-item operands of work items [i0, i1): tile ids, centres, the
    rows' (qa, qb, qc) per ray, raw weights, membership, slab features, bin
    gates, edges minus t_c, and block ids."""
    gt = geo.g_tile
    t, j, b = lists[0, i0:i1].long(), lists[1, i0:i1].long(), lists[2, i0:i1].long()
    bl, bh = lists[4, i0:i1], lists[5, i0:i1]
    tile = j * geo.t_ang + t
    a = aux[tile]
    x0, y0, z0 = (a[:, 4 + i, None] for i in range(3))
    tab = table.reshape(-1, gt, table.shape[1])[b]  # (nb, gt, F)
    gp = _center_transform(tab[..., :FDIM], x0, y0, z0)
    memb = _member_of(words.reshape(-1, gt)[b], t[:, None], geo.n_tt, geo.n_pt)
    x = slab[tile]  # (nb, 30, S)
    xt = x.transpose(1, 2)[:, None]  # (nb, 1, S, 30)
    q = [quad_form(gp[:, :, None], xt[..., i * FDIM:(i + 1) * FDIM])
         for i in range(3)]  # (nb, gt, S)
    bins = torch.arange(geo.t_chunk, device=slab.device)
    gate = (bins[None, :] >= bl[:, None]) & (bins[None, :] <= bh[:, None])
    s_e = edges[j] - a[:, 3:4]  # (nb, t_chunk + 1)
    return tile, (x0, y0, z0), q, tab[..., FDIM:FDIM + c], memb, x, gate, s_e, b


def _batches(n, geo):
    return _item_batches(n, geo.g_tile, geo.s_ang * (geo.t_chunk + 1))


def _analytic_fwd_plain(slab, aux, edges, table, words, fwd, n_items, geo, c):
    tb, s = geo.t_chunk, geo.s_ang
    out = torch.zeros((slab.shape[0], c, s * tb), dtype=slab.dtype, device=slab.device)
    for i0, i1 in _batches(int(n_items[0]), geo):
        tile, _, (qa, qb, qc), w, memb, _, gate, s_e, _ = _an_items(
            slab, aux, edges, table, words, fwd, i0, i1, geo, c
        )
        _, _, shift, _, pref, shq = _section_terms(qa, qb, qc)
        cdf = torch.erf(shq[..., None] * (s_e[:, None, None, :] + shift[..., None]))
        tau = pref[..., None] * (cdf[..., 1:] - cdf[..., :-1]) * gate[:, None, None, :]
        nb, gt = tau.shape[:2]
        wm = (w * memb[..., None]).transpose(1, 2)  # (nb, C, gt)
        o = (wm @ tau.reshape(nb, gt, s * tb)).reshape(nb, c, s, tb)
        out.index_add_(0, tile, o.transpose(2, 3).reshape(nb, c, tb * s))
    return out


def _analytic_bwd_plain(slab, aux, edges, table, words, bwd, n_items, go, geo, c):
    gt, tb, s = geo.g_tile, geo.t_chunk, geo.s_ang
    dtable = torch.zeros_like(table)
    ar = torch.arange(gt, device=table.device)
    for i0, i1 in _batches(int(n_items[0]), geo):
        tile, (x0, y0, z0), (qa, qb, qc), w, memb, x, gate, s_e, b = _an_items(
            slab, aux, edges, table, words, bwd, i0, i1, geo, c
        )
        inv_qa, half_qb, shift, eh, pref, shq = _section_terms(qa, qb, qc)
        z = shq[..., None] * (s_e[:, None, None, :] + shift[..., None])  # (nb, gt, S, E)
        cdf, ex = torch.erf(z), torch.exp(-z * z)
        g4 = gate[:, None, None, :]
        i0_ = pref[..., None] * (cdf[..., 1:] - cdf[..., :-1]) * g4  # (nb, gt, S, tb)
        nb = i0_.shape[0]
        gos = go[tile].reshape(nb, c, tb, s).transpose(2, 3)  # (nb, C, S, tb)
        dt = sum(w[..., ci, None, None] * gos[:, ci, None] for ci in range(c)) * g4
        dw = torch.stack([(i0_ * gos[:, ci, None]).sum(dim=(2, 3)) for ci in range(c)], -1)
        sx = s_e[:, None, None, :] * ex
        a0 = (dt * i0_).sum(-1)  # (nb, gt, S)
        ae = (dt * (ex[..., :-1] - ex[..., 1:])).sum(-1)
        as_ = (dt * (sx[..., 1:] - sx[..., :-1])).sum(-1)
        s1 = (eh * ae - half_qb * a0) * inv_qa
        s2 = (a0 - half_qb * s1 - eh * as_) * inv_qa
        dgp = sum(
            (-0.5 * dq) @ x[:, i * FDIM:(i + 1) * FDIM].transpose(1, 2)
            for i, dq in enumerate((s2, s1, a0))
        )  # (nb, gt, 10)
        mf = memb[..., None].to(table.dtype)
        dg = _center_transform_t(dgp, x0, y0, z0) * mf
        rows = (b[:, None] * gt + ar[None, :]).reshape(-1)
        upd = torch.zeros((rows.shape[0], table.shape[1]), dtype=table.dtype,
                          device=table.device)
        upd[:, :FDIM] = dg.reshape(-1, FDIM)
        upd[:, FDIM:FDIM + c] = (dw * mf).reshape(-1, c)
        dtable.index_add_(0, rows, upd)
    return dtable


class AnalyticRSortField(torch.autograd.Function):
    """Work-list-sparse optical depths (T_tot, C, S) of the padded table,
    with the K6 backward. Only `table` is differentiable."""

    @staticmethod
    def forward(ctx, table, slab, aux, edges, words, fwd, bwd, n_items, geo, c):
        ctx.save_for_backward(slab, aux, edges, table, words, bwd, n_items)
        ctx.geo, ctx.c = geo, c
        return analytic_fwd(slab, aux, edges, table, words, fwd, n_items, geo, c)

    @staticmethod
    def backward(ctx, go):
        slab, aux, edges, table, words, bwd, n_items = ctx.saved_tensors
        dtable = analytic_bwd(slab, aux, edges, table, words, bwd, n_items,
                              go.contiguous(), ctx.geo, ctx.c)
        return (dtable,) + (None,) * 9


def analytic_gaussian_field(gfeat, channel_weights, grid, tiles: RSortTiles,
                            spec: RSortSpec, cam):
    """Closed-form per-bin field (num_r, ns, ns, C) + overflow flag. Values
    are tau / bin_width, the bin average of the field the numerical backends
    sample at bin centres.

    With `tiles` from `rsort_cull(..., gw=cat([gfeat, channel_weights]))`
    the field reads the table the cull gathered; from a cull without `gw`,
    the table is gathered here (`fused_rsort._field_table`)."""
    num_r, ns = grid.r.shape[0], grid.theta.shape[0]
    n_tt, n_pt, n_ch = _tile_counts(ns, num_r, spec)
    c = channel_weights.shape[1]
    table = _field_table(tiles, gfeat, channel_weights, "analytic_gaussian_field")
    with torch.no_grad():
        slab, aux, edges = analytic_operands(grid, cam, spec)
    geo = RSortGeometry(n_tt, n_pt, n_ch, spec.t_chunk, spec.g_tile,
                        spec.t_theta * spec.t_phi, spec.t_phi)
    out = AnalyticRSortField.apply(
        table, slab, aux, edges,
        tiles.words.reshape(-1).contiguous(), tiles.fwd, tiles.bwd,
        tiles.n_items, geo, c,
    )
    tp = TileSpec(t_theta=spec.t_theta, t_phi=spec.t_phi, t_r=spec.t_chunk)
    field = untile_field_t(out, ns, num_r, tp, n_tt, n_pt, n_ch)
    widths = (edges[:, 1:] - edges[:, :-1]).reshape(-1)[:num_r]
    return field / widths[:, None, None, None], tiles.overflowed
