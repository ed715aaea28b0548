"""Duplicated-layout field renderer ('pallas_dsort').

Port of `nlos_gaussian_renderer_tpu/ops/fused_dsort.py`. Where the rsort
layout keeps each Gaussian in one table row shared by every angular tile it
touches, dsort duplicates each Gaussian into every (fine) angular tile its
footprint touches, so every g_tile block of the padded table belongs to
exactly one tile (tile-pure blocks). It adds no kernel: the work lists and
the field run on the rsort kernels K1-K4 unchanged.

  1. **Duplicates** (`dsort_schedule`): each Gaussian's footprint rectangle
     (first touched tile by argmax, counts per axis) is enumerated row-major
     into at most `d_max` duplicates (more raise `overflowed`); a packed key
     (tile | quantized d) is sorted stably with the flat index i*d_max + k,
     so each sorted row knows its Gaussian i and duplicate k.
  2. **Layout**: per-tile runs, each padded to whole g_tile blocks (a row
     past the padded capacity raises `overflowed`). Each valid slot carries
     the 1x1 rect word of its own tile (`fused_rsort._rect_bits`' encoding),
     padding slots word 0. The JAX version gives every duplicate the
     all-tiles word and builds its lists in XLA glue; K1 derives each (block,
     tile) range from the rows' words, so the all-tiles word would list a
     block in every tile and K3 would add it in tiles it does not own. The
     1x1 word makes K1 and K2 build exactly JAX's one-tile-per-block lists,
     and K3/K4's membership test passes exactly where JAX's all-ones word
     does.
  3. **Work lists**: the padded [word | d-r | d+r | src] rows go through
     `fused_rsort._lists_from_rows` (the `full_perm` cast, K1, K2).
  4. **Field** (`dsort_gaussian_field`): forms and weights gathered with
     `DupGather` into the padded layout, then K3/K4 (`RSortField`). The
     backward of the gather reads each Gaussian's duplicate rows through a
     (G, d_max) slot table and sums them in one fixed-order reduction: no
     float atomics, so it is the same bit for bit on every run, eagerly
     and from a CUDA graph (the JAX version's is one scatter-add). K4 writes every row of its output, so
     JAX's `mask_dead_blocks` stays moot here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from nlos_gaussian_renderer_tpu_torch.ops.fused import _cdiv, angular_footprints
from nlos_gaussian_renderer_tpu_torch.ops.fused_rsort import (
    RSortSpec,
    _lists_from_rows,
    _rect_bits,
    sampled_field,
)


class DSortTiles(NamedTuple):
    """Duplicated-layout cull result; the kernel-facing fields mirror
    `fused_rsort.RSortTiles` (`fwd_t` ... `bwd_bh` name the list rows)."""

    full_perm: torch.Tensor  # (G_pad,) int64 padded slot -> original row (0 for padding)
    slots: torch.Tensor  # (G, d_max) int64 padded slot of each duplicate, G_pad where none
    words: torch.Tensor  # (G_pad, 1) int32 1x1 rect word of the slot's tile, 0 for padding
    counts: torch.Tensor  # (T_ang,) per-tile duplicate counts (diagnostics)
    fwd: torch.Tensor  # (6, W) int32, sorted by (tile, chunk, block)
    bwd: torch.Tensor  # (6, W) int32, block-major
    n_items: torch.Tensor  # (1,) int32
    tile_has_work: torch.Tensor  # (T_ang, n_ch) bool
    blk_has_work: torch.Tensor  # (KB,) bool
    max_dups: torch.Tensor  # () observed per-Gaussian duplicate count
    n_rows: torch.Tensor  # () observed valid duplicate rows
    overflowed: torch.Tensor  # () bool: any capacity saturated
    rows: torch.Tensor  # (G_pad, 4) f32 padded [word | d-r | d+r | src] rows

    fwd_t = property(lambda self: self.fwd[0])
    fwd_j = property(lambda self: self.fwd[1])
    fwd_b = property(lambda self: self.fwd[2])
    fwd_first = property(lambda self: self.fwd[3])
    fwd_bl = property(lambda self: self.fwd[4])
    fwd_bh = property(lambda self: self.fwd[5])
    bwd_t = property(lambda self: self.bwd[0])
    bwd_j = property(lambda self: self.bwd[1])
    bwd_b = property(lambda self: self.bwd[2])
    bwd_first = property(lambda self: self.bwd[3])
    bwd_bl = property(lambda self: self.bwd[4])
    bwd_bh = property(lambda self: self.bwd[5])


def _dsort_rows(g: int, spec: RSortSpec) -> int:
    return spec.dup_rows if spec.dup_rows > 0 else g * spec.d_max


def _padded_rows(g: int, spec: RSortSpec, t_ang: int) -> int:
    """Padded capacity: the duplicate rows plus one partial block a tile."""
    return _cdiv(_dsort_rows(g, spec), spec.g_tile) * spec.g_tile + t_ang * spec.g_tile


def dsort_schedule(d, radius, m_th, m_ph, in_window, r, n_tt: int, n_pt: int,
                   spec: RSortSpec) -> DSortTiles:
    """Duplicates, layout and work lists from per-Gaussian footprint
    geometry (`angular_footprints`' outputs; the half of `dsort_cull` after
    it)."""
    g = d.shape[0]
    dev = d.device
    t_ang = n_tt * n_pt
    d_max = spec.d_max
    g_pad = _padded_rows(g, spec, t_ang)
    if g_pad >= (1 << 24):
        raise ValueError(
            f"dsort padded rows {g_pad} >= 2^24: the padded rows' source column is an "
            "f32, exact to 24 bits; shrink d_max, dup_rows or g_tile"
        )
    b_t, b_p, b_total = _rect_bits(n_tt, n_pt)
    if b_total > 23:
        raise ValueError(
            f"rect word needs {b_total} bits (> 23): it rides the padded rows as an "
            f"f32, exact to 24 bits, at this tile grid ({n_tt}x{n_pt})"
        )
    i32 = torch.int32

    # Touched-tile rectangle per Gaussian: footprints are contiguous per axis.
    a0 = m_th.to(i32).argmax(dim=1)
    cnt_a = m_th.sum(dim=1, dtype=i32)
    b0 = m_ph.to(i32).argmax(dim=1)
    cnt_b = m_ph.sum(dim=1, dtype=i32)
    valid = in_window & (cnt_a > 0) & (cnt_b > 0)
    cnt = torch.where(valid, cnt_a * cnt_b, 0)
    dup_overflow = torch.any(cnt > d_max)

    # Up to d_max duplicates, row-major in the rectangle.
    k = torch.arange(d_max, dtype=i32, device=dev)
    cb = torch.clamp(cnt_b, min=1)[:, None]
    ka = k[None, :] // cb
    kb_ = k[None, :] - ka * cb
    tile_k = (a0[:, None] + ka) * n_pt + (b0[:, None] + kb_)  # (G, d_max)
    dup_valid = valid[:, None] & (k[None, :] < cnt[:, None])

    # Packed key (tile | sentinel t_ang) * 2^dq_bits + quantized d, sorted
    # stably with the flat index i * d_max + k.
    t_bits = max(int(t_ang).bit_length(), 1)
    dq_bits = min(30 - t_bits, 16)
    if dq_bits < 8:
        raise ValueError(f"angular tiling too fine to pack keys: {t_ang}")
    d_lo = torch.amin(d)
    d_span = torch.clamp(torch.amax(d) - d_lo, min=1e-6)
    dq = torch.clamp(((d - d_lo) / d_span * ((1 << dq_bits) - 1)).to(i32), 0,
                     (1 << dq_bits) - 1)
    key = torch.where(dup_valid, tile_k, t_ang) * (1 << dq_bits) + dq[:, None]
    key_s, flat = torch.sort(key.reshape(-1), stable=True)
    src_s = flat // d_max
    tile_s = key_s >> dq_bits  # ascending
    valid_s = tile_s < t_ang
    n_rows = valid_s.sum(dtype=i32)

    # Per-tile runs -> block-aligned layout.
    tids = torch.arange(t_ang, dtype=i32, device=dev)
    left = torch.searchsorted(tile_s, tids)
    cnt_t = torch.searchsorted(tile_s, tids, right=True) - left
    padded_t = (cnt_t + spec.g_tile - 1) // spec.g_tile * spec.g_tile
    start_t = torch.cumsum(padded_t, dim=0) - padded_t
    tile_idx = torch.clamp(tile_s, max=t_ang - 1).long()
    pos = torch.arange(g * d_max, device=dev) - left[tile_idx]
    dest = torch.where(valid_s, start_t[tile_idx] + pos, g_pad)
    row_overflow = torch.any(torch.where(valid_s, dest, 0) >= g_pad)
    dest = torch.clamp(dest, max=g_pad)  # dropped duplicates go to the sentinel row

    # Each valid slot: its tile's 1x1 rect word, the Gaussian's radial
    # interval and its row; padding slots stay 0 (word 0: no member).
    tt, pt = tids // n_pt, tids % n_pt
    word_t = ((((1 << b_t) | tt) << b_t | tt) << b_p | pt) << b_p | pt
    vals = torch.stack([word_t[tile_idx].to(d.dtype), (d - radius)[src_s],
                        (d + radius)[src_s], src_s.to(d.dtype)], dim=1)
    rows = d.new_zeros((g_pad + 1, 4))
    rows[dest] = vals
    rows = rows[:g_pad]
    slots = torch.empty_like(dest)
    slots[flat] = dest
    full_perm, words, lists = _lists_from_rows(rows, 0, r, n_tt, n_pt, spec)
    return DSortTiles(
        full_perm=full_perm,
        slots=slots.reshape(g, d_max),
        words=words[:, None],
        counts=cnt_t,
        fwd=lists.fwd,
        bwd=lists.bwd,
        n_items=lists.n_items,
        tile_has_work=lists.tile_has_work,
        blk_has_work=lists.blk_has_work,
        max_dups=torch.amax(cnt),
        n_rows=n_rows,
        overflowed=dup_overflow | row_overflow | lists.overflowed,
        rows=rows,
    )


def dsort_cull(means, scales, alive, cam, theta, phi, r, spec: RSortSpec,
               scaling_modifier: float = 1.0) -> DSortTiles:
    """Duplicated-layout cull + schedule for one scan point. The cull
    geometry carries no gradient."""
    ns = theta.shape[0]
    with torch.no_grad():
        d, radius, m_th, m_ph, in_window = angular_footprints(
            means.detach(), scales.detach(), alive, cam, theta, phi, r, spec,
            scaling_modifier,
        )
        return dsort_schedule(d, radius, m_th, m_ph, in_window, r,
                              _cdiv(ns, spec.t_theta), _cdiv(ns, spec.t_phi), spec)


class DupGather(torch.autograd.Function):
    """Rows `table[full_perm]` (with duplicates) of a (G, F) table into the
    padded layout. Backward: original row i gets the sum of its duplicate
    rows' cotangents, read through the (G, d_max) slot table
    (`DSortTiles.slots`; the sentinel G_pad reads an appended zero row):
    one gather and one reduction over the duplicate axis, whose order is
    fixed by the shapes (no float atomics), so it is bit for bit run to run
    and from a CUDA graph. Padding slots alias row 0 in the forward and are
    never read back; the kernels give them zero cotangents anyway (word 0).
    The plain form of this backward is one `index_add_` over `full_perm`."""

    @staticmethod
    def forward(ctx, table, full_perm, slots):
        ctx.save_for_backward(slots)
        return table[full_perm]

    @staticmethod
    def backward(ctx, grad):
        (slots,) = ctx.saved_tensors
        gz = torch.cat([grad, grad.new_zeros(1, grad.shape[1])])
        return gz[slots].sum(dim=1), None, None


dup_gather = DupGather.apply  # JAX's `fused_dsort.dup_gather`


def dsort_gaussian_field(gfeat, channel_weights, tiles: DSortTiles, spec: RSortSpec,
                         grid, cam):
    """Duplicated-layout field (num_r, ns, ns, C) + overflow flag: forms and
    weights gathered by `DupGather` beside the cull's rows, then K3/K4."""
    gw_pad = dup_gather(torch.cat([gfeat, channel_weights], dim=1), tiles.full_perm,
                        tiles.slots)
    table = torch.cat([gw_pad, tiles.rows], dim=1)  # [forms | weights | word | 3 geometry]
    return sampled_field(table, tiles, spec, grid, cam, channel_weights.shape[1]), \
        tiles.overflowed


@torch.no_grad()
def tune_dsort_spec(scene, camera_positions, box_points, num_sampling_points: int,
                    start: int, end: int, c: float, delta_t: float,
                    base: RSortSpec = RSortSpec(t_theta=4, t_phi=4),
                    headroom: float = 1.25, scaling_modifier: float = 1.0) -> RSortSpec:
    """Fit `d_max` / `dup_rows` / `w_max` to a scene by culling the probe
    cameras once at generous capacities (JAX's rule): a slot for every
    (block, chunk) pair (a block has one tile), and, where the probe's
    `d_max` truncated the duplicates, a second probe at the true maximum."""
    from nlos_gaussian_renderer_tpu_torch.ops.sampling import shell_grid

    g = scene.capacity
    dev = scene.means.device
    cams = torch.as_tensor(camera_positions, dtype=torch.float32, device=dev).reshape(-1, 3)
    t_ang = _cdiv(num_sampling_points, base.t_theta) * _cdiv(num_sampling_points,
                                                            base.t_phi)
    n_ch = _cdiv(end - start, base.t_chunk)

    def probe_at(d_max: int) -> RSortSpec:
        pr = base._replace(d_max=d_max, dup_rows=0)
        kb = _padded_rows(g, pr, t_ang) // base.g_tile
        return pr._replace(w_max=max(kb * n_ch, 1))

    def measure(pr):
        mi, md, mr = 1, 1, 1
        for cam in cams:
            grid = shell_grid(cam, box_points, num_sampling_points, start, end, c, delta_t)
            t = dsort_cull(scene.means, scene.scales, scene.alive, cam, grid.theta,
                           grid.phi, grid.r, pr, scaling_modifier)
            mi = max(mi, int(t.n_items[0]))
            md = max(md, int(t.max_dups))
            mr = max(mr, int(t.n_rows))
        return mi, md, mr

    probe = probe_at(max(base.d_max, 16))
    max_items, max_dups, max_rows = measure(probe)
    if max_dups > probe.d_max:
        # The probe's d_max truncated the enumeration (max_dups is counted
        # before the cap): probe again at the true maximum.
        max_items, max_dups, max_rows = measure(probe_at(max_dups))
    return base._replace(
        d_max=max_dups + max(2, max_dups // 4),
        dup_rows=int(max_rows * headroom) + base.g_tile,
        w_max=int(max_items * headroom) + 8,
    )
