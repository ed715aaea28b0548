"""Work counts and roofline bounds of the field kernels, from their work
lists: what `chip_smoke.py` phase 3 holds each launch to, and what
`geomsweep` reads at each point of the sweep.

A bound is the least time the card could take for a launch's work: the
larger of the bytes it must move (each input read once, each output
written once) over HBM bandwidth, and its FP32 operations and MUFU
transcendentals over their peak rates, counted from this launch's lists
(`roofline`). K3/K4 (`rsort_fwd`/`rsort_bwd`, on the lists of
`pallas_rsort` and of `pallas_dsort`) do one (row, sample) pair for every
member row of an item's block at every sample of the item's bins [bl,
bh] and its tile's rays (`rsort_field_work`): per pair K3 evaluates the
10-term form, one exp and C multiply-adds (2 (10 + C) FP32, 1 MUFU;
`csrc/rsort_fwd.cu`), K4 the form, the exp and the rank-C Z accumulation
(20 + 22 C FP32, 1 MUFU; `csrc/rsort_bwd.cu`).
"""

from __future__ import annotations

import torch

from nlos_gaussian_renderer_tpu_torch.ops import fused_analytic as fa
from nlos_gaussian_renderer_tpu_torch.ops import fused_rsort as fr
from nlos_gaussian_renderer_tpu_torch.ops.fused import FDIM  # the form's 10 monomials

# Peak rates of one H100 SXM at its 700 W limit: HBM3 bytes/s and non-tensor
# FP32 FLOP/s (NVIDIA's data sheet), and MUFU (SFU) results/s: 16 per SM per
# clock (CUDA C++ Programming Guide, throughput table, compute capability
# 9.0) x 132 SMs x 1.98 GHz boost.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
MUFU_PER_S = 16 * 132 * 1.98e9


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def roofline(n_bytes, flops, mufu):
    """(bound ms, 'bytes' or 'operations', which of bytes / fp32 / mufu)."""
    times = {"bytes": n_bytes / HBM_BYTES_PER_S, "fp32": flops / FP32_FLOP_PER_S,
             "mufu": mufu / MUFU_PER_S}
    what = max(times, key=times.get)
    return times[what] * 1e3, ("bytes" if what == "bytes" else "operations"), what


def rsort_field_work(words, fwd, n_items, geo: fr.RSortGeometry, table_cols: int,
                     c: int) -> dict:
    """K3's and K4's work on one cull's lists: the rect words (G_pad,) or
    (G_pad, 1), the forward list (6, W) (the backward list holds the same
    items), n_items (1,), the list's geometry and the table's width.
    Returns {'items', 'row_rays' ((member row, ray) pairs), 'pairs' ((row,
    sample) pairs), 'rsort_fwd' and 'rsort_bwd': (bytes, FP32 ops, MUFU
    ops)}. The bytes are those of the launches' tensors: xfeat (T_tot, 10,
    S), centers (T_tot, 3), the table, the words, the list, the output
    (T_tot, C, S); K4 reads the cotangent (T_tot, C, S) and writes a
    table-shaped gradient."""
    n = int(n_items[0])
    rows = words.numel()
    lists = fwd[:, :n].long()
    memb = fr._member_of(words.reshape(-1, geo.g_tile)[lists[2]], lists[0][:, None],
                         geo.n_tt, geo.n_pt)
    rows_it = memb.sum(1).double()
    bins_it = (lists[5] - lists[4] + 1).double()
    row_rays = float((rows_it * geo.s_ang).sum())
    pairs = float((rows_it * bins_it * geo.s_ang).sum())
    t_tot, s = geo.n_tt * geo.n_pt * geo.n_ch, geo.s_ang * geo.t_chunk
    common = 4 * (t_tot * FDIM * s + t_tot * 3 + rows * table_cols + rows + fwd.numel())
    field = 4 * t_tot * c * s
    return {"items": n, "row_rays": row_rays, "pairs": pairs,
            "rsort_fwd": (common + field, pairs * 2 * (10 + c), pairs),
            "rsort_bwd": (common + field + 4 * rows * table_cols, pairs * (20 + 22 * c),
                          pairs)}


def k5_unit_bins(fwd, n_items, geo):
    """(units,) float64: the (item, bin) pairs each K5 unit covers, from the
    plain schedule (a unit's (row, bin, ray) triples are g_tile * S_ang
    times as many)."""
    u_f = fa.AN_FWD_SLAB_BINS
    n = int(n_items[0])
    sched = fr._fwd_groups_plain(fwd, n_items, geo, fa.AN_FWD_GROUP_ITEMS, u_f).long()
    ng = int((sched[2] != fr._DEAD_KEY).sum())
    items = torch.arange(n)
    group = torch.searchsorted(sched[0, :ng], items, right=True) - 1
    g_lo = sched[3][group]
    bl, bh = fwd[4, :n].long(), fwd[5, :n].long()
    k_lo, k_hi = (bl - g_lo) // u_f, (bh - g_lo) // u_f
    cnt = k_hi - k_lo + 1
    it = torch.repeat_interleave(items, cnt)
    k = torch.repeat_interleave(k_lo - (torch.cumsum(cnt, 0) - cnt), cnt) + torch.arange(
        it.shape[0])
    b0 = g_lo[it] + k * u_f
    bins = torch.minimum(bh[it], b0 + u_f - 1) - torch.maximum(bl[it], b0) + 1
    return torch.bincount(sched[5][group[it]] + k, weights=bins.double(),
                          minlength=int(sched[5, -1]))


def bwd_unit_bins(bwd, n_items, unit_bins):
    """(units,) float64: the bins each K4 or K6 unit covers."""
    off = fr._bwd_unit_offsets_plain(bwd, n_items, unit_bins)
    _, lo, hi = fr.bwd_units(off, bwd, unit_bins)
    return (hi - lo + 1).double()


def live_pairs(an, lists, n_items, geo, c):
    """(items,) float64: each item's (member row, ray) pairs whose
    exp(-phi/2) is nonzero in f32, from the plain version's section terms
    (`fused_analytic._section_terms`). Every other pair adds exact zeros to
    the K5 output and to K6's A0, S1, S2 and dw, so the functions need no
    edge of it."""
    out = [torch.zeros(0, dtype=torch.float64, device=lists.device)]
    for i0, i1 in fa._batches(int(n_items[0]), geo):
        _, _, (qa, qb, qc), _, memb, *_ = fa._an_items(*an, lists, i0, i1, geo, c)
        eh = fa._section_terms(qa, qb, qc)[3]
        out.append(((eh != 0) & memb[..., None]).sum((1, 2)).double())
    return torch.cat(out)


def cta_work(fwd, bwd, n_items, geo):
    """(row, sample) pairs each CTA of K3 and K4, and (row, bin, ray)
    triples each CTA of K5 and K6 walks, from the work lists: {scheme:
    tensor over the CTAs with work}. 'before' is the schedule K3/K4 had
    before their work units (K4 one CTA per Gaussian block; K3 one CTA per
    (tile, slice) walking the tile's items that touch the slice), which K6
    and K5 kept until theirs; 'units' the present one (K4 one CTA per
    (unit, 256-row chunk); K3 one CTA per (group, slice) unit; K6 as K4 at
    its own unit width; K5 one CTA per (group, slab) unit, 128 rays)."""
    n = int(n_items[0])
    fwd, bwd = fwd.cpu(), bwd.cpu()
    s_ang, gt = geo.s_ang, geo.g_tile
    s_tot = s_ang * geo.t_chunk
    out = {}
    samples = (bwd[5, :n] - bwd[4, :n] + 1).double() * s_ang
    per_block = torch.bincount(bwd[2, :n].long(), weights=samples)
    out["K4 before"] = per_block[per_block > 0] * gt
    for k, u_b in (("K4", fr.BWD_UNIT_BINS), ("K6", fa.AN_BWD_UNIT_BINS)):
        out[f"{k} units"] = (bwd_unit_bins(bwd, n_items.cpu(), u_b) * s_ang
                             * min(gt, 256)).repeat(fr._cdiv(gt, 256))

    def slices_of(items):
        """(item, slice) pairs: the slices each item's bins touch."""
        s_lo = fwd[4, items].long() * s_ang // fr.FWD_SLICE
        s_hi = ((fwd[5, items].long() + 1) * s_ang - 1) // fr.FWD_SLICE
        cnt = s_hi - s_lo + 1
        it = torch.repeat_interleave(items, cnt)
        first = torch.repeat_interleave(torch.cumsum(cnt, 0) - cnt, cnt)
        return it, torch.repeat_interleave(s_lo, cnt) + torch.arange(it.shape[0]) - first

    def pairs(slc):
        return (torch.clamp(s_tot - slc * fr.FWD_SLICE, max=fr.FWD_SLICE) * gt).double()

    items = torch.arange(n)
    it, slc = slices_of(items)
    n_sl = fr._cdiv(s_tot, fr.FWD_SLICE)
    key = fwd[0, it].long() * geo.n_ch + fwd[1, it].long()
    cta = key * n_sl + slc
    uniq, cnt = torch.unique(cta, return_counts=True)
    out["K3 before"] = cnt.double() * pairs(uniq % n_sl)
    sched = fr._fwd_groups_plain(fwd, n_items.cpu(), geo, fr.FWD_GROUP_ITEMS).long()
    n_groups = int((sched[2] != fr._DEAD_KEY).sum())
    group = torch.searchsorted(sched[0, :n_groups], it, right=True) - 1
    unit = sched[5][group] + slc - sched[3][group]
    n_units = int(sched[5, -1])
    per_unit = torch.bincount(unit, minlength=n_units)
    _, u_slc = fr.fwd_units(sched)
    out["K3 units"] = (per_unit.double() * pairs(u_slc))[per_unit > 0]

    bins = k5_unit_bins(fwd, n_items.cpu(), geo)
    out["K5 units"] = bins[bins > 0] * gt * s_ang
    return out
