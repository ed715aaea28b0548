"""Group-sorted, work-list-scheduled field renderer ('pallas_rsort').

Port of `nlos_gaussian_renderer_tpu/ops/fused_rsort.py`. One render of one
scan point:

  1. **Cull geometry** (`_cull_geometry`; kernel L1, `cull_geometry`): each
     Gaussian's 3-sigma sphere gives a camera distance d, a radius, and a
     footprint RECTANGLE of angular tiles, packed into one rect word
     [valid | th_lo | th_hi | ph_lo | ph_hi] (`_rect_bits`, the JAX bit
     layout, so words compare equal across the packages), with the per-tile
     counts, the layout's sort key and the padded table's geometry columns.
  2. **Layout** (`_layout_from_geometry`): a stable sort by (word, d) (the
     library's sort) and block-aligned pattern groups (kernel L2,
     `cull_layout`): every g_tile block is pattern-pure and d-contiguous,
     so its radial footprint per tile is a tight interval.
     A frozen layout (`rsort_layout`, from a reference camera with a radial
     slack) skips this step: built once, it serves many scan points, whose
     words and block intervals are still this camera's, so the render is
     exact; a Gaussian it holds no slot for raises the overflow flag.
  3. **Wide gather** (`WidePadGather`; kernel L3, `wide_gather_fwd` /
     `_bwd`): the differentiable forms|weights and the geometry columns ride
     one row gather into the padded layout; the backward is the
     inverse-permutation gather.
  4. **Work lists**: kernel K1 (`cull_reduce`) reads the geometry columns
     of the padded table in place and reduces each (block, tile) pair to an
     absolute active-bin range (writing the int32 words beside); kernel K2
     (`build_work_lists`) expands pairs over radial chunks into the
     block-major backward list and the (tile, chunk, block)-sorted forward
     list, and writes every other output of the schedule (counts, has-work
     and overflow flags, zero tails): after the gather the schedule
     launches one cast, K1 and K2 (`_lists_from_rows`).
  5. **Field**: kernel K3 (`rsort_fwd`) sums each output tile's items;
     kernel K4 (`rsort_bwd`) accumulates each Gaussian block's gradient rows
     (`RSortField`, an autograd Function). While the port's tracing is on
     (`utils/profiling`), `listed_pairs` adds the (row, sample) pairs K3
     evaluates to the device counter `cull.listed_pairs`.

Each kernel wrapper launches its CUDA kernel (`csrc/`) for CUDA tensors and
raises on anything it cannot take; for CPU tensors it runs the plain PyTorch
version defined beside it, which is also what `chip_smoke.py` holds the
kernel against on the card. The quadratic form is evaluated in f32 in the
tile-centred basis (`_center_transform`); the JAX kernels' bf16x3 split,
their f32 scaled-floor word decode, the one-hot/stair matmuls and the packed
work-list words existed for the TPU's MXU, Mosaic and SMEM and are not ported.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from nlos_gaussian_renderer_tpu_torch.ops.cuda_build import (
    KERNELS,
    check_tensor,
    on_cpu,
    ptr,
)
from nlos_gaussian_renderer_tpu_torch.ops.fused import (
    FDIM,
    TileSpec,
    _cdiv,
    angular_footprints,
    quad_form,
    tile_points_centered_direct_t,
    untile_field_t,
)
from nlos_gaussian_renderer_tpu_torch.utils import profiling


def _rect_bits(n_tt: int, n_pt: int):
    """Static bit widths (b_t, b_p, total) of the packed rectangle word,
    MSB first: [valid(1) | th_lo(b_t) | th_hi(b_t) | ph_lo(b_p) | ph_hi(b_p)].
    """
    b_t = max(int(n_tt - 1).bit_length(), 1)
    b_p = max(int(n_pt - 1).bit_length(), 1)
    return b_t, b_p, 1 + 2 * b_t + 2 * b_p


def _decode_words(words, n_tt: int, n_pt: int):
    """int32 rect words -> (valid, th_lo, th_hi, ph_lo, ph_hi), integer ops."""
    b_t, b_p, _ = _rect_bits(n_tt, n_pt)
    v = words.to(torch.int32)
    ph_hi = v & ((1 << b_p) - 1)
    v = v >> b_p
    ph_lo = v & ((1 << b_p) - 1)
    v = v >> b_p
    th_hi = v & ((1 << b_t) - 1)
    v = v >> b_t
    th_lo = v & ((1 << b_t) - 1)
    return (v >> b_t) > 0, th_lo, th_hi, ph_lo, ph_hi


def _member_of(words, t, n_tt: int, n_pt: int):
    """Does each word's rectangle cover angular tile `t` (broadcast)?"""
    valid, th_lo, th_hi, ph_lo, ph_hi = _decode_words(words, n_tt, n_pt)
    tt, pt = t // n_pt, t % n_pt
    return valid & (tt >= th_lo) & (tt <= th_hi) & (pt >= ph_lo) & (pt <= ph_hi)


def decode_rect_members(words, n_tt: int, n_pt: int):
    """(R,) int32 rect words -> (R, n_tt*n_pt) bool membership."""
    t = torch.arange(n_tt * n_pt, device=words.device)
    return _member_of(words.reshape(-1)[:, None], t[None, :], n_tt, n_pt)


class RSortSpec(NamedTuple):
    """Static configuration of the rsort renderer.

    The fields match the JAX `RSortSpec`, so configs carry over. The port
    computes in f32 and ignores `bwd_p_bf16`, `bwd_exp_bf16`, `fwd_p_bf16`
    (bf16 variants of the TPU kernels) and `ws_pallas` (the work lists
    always go through K1/K2); `d_max`/`dup_rows` size the duplicated layout
    of `pallas_dsort` (`fused_dsort.py`). Its
    kernels cover exactly each item's bin range [bl, bh], so `gate_bins`
    only has to divide `t_chunk`; `mask_dead_blocks` is moot because K4
    and K6 write every row of their output, zeros in the blocks no item
    names. That covers a frozen layout's slots too: a row this camera
    culls keeps its slot with word 0, its block may have no item, and its
    cotangent row is 0 either way (the gather's backward also routes it to
    the zero row, `rsort_schedule`).
    """

    t_theta: int = 8
    t_phi: int = 16
    t_chunk: int = 8  # radial bins per chunk
    g_tile: int = 256
    w_max: int = 4096  # work-list capacity: (tile, chunk, block) triples
    max_groups: int = 64  # pattern-group capacity (excess groups merge)
    sigma_cull: float = 3.0
    margin: float = 1.1
    gate_bins: int = 4
    bwd_p_bf16: bool = False
    bwd_exp_bf16: bool = False
    fwd_p_bf16: bool = False
    d_max: int = 8
    dup_rows: int = 0
    mask_dead_blocks: bool = False
    ws_pallas: bool = True


class RSortTiles(NamedTuple):
    """Cull result: the padded (pattern, d)-sorted layout plus work lists.

    `fwd` and `bwd` hold the six int32 lists of each order as rows
    (t, j, b, first, bl, bh); the `fwd_t` ... `bwd_bh` properties name them
    as the JAX `RSortTiles` fields. Slots past `n_items` are zero.
    """

    full_perm: torch.Tensor  # (G_pad,) int64 padded slot -> original row
    inv_perm: torch.Tensor  # (G,) int64 original row -> padded slot (G_pad = culled)
    words: torch.Tensor  # (G_pad, 1) int32 packed rect words
    counts: torch.Tensor  # (T_ang,) per-tile member counts (diagnostics)
    fwd: torch.Tensor  # (6, W) int32, sorted by (tile, chunk, block)
    bwd: torch.Tensor  # (6, W) int32, block-major
    n_items: torch.Tensor  # (1,) int32 valid work items
    tile_has_work: torch.Tensor  # (T_ang, n_ch) bool
    blk_has_work: torch.Tensor  # (KB,) bool
    n_groups: torch.Tensor  # () observed pattern groups (diagnostics)
    overflowed: torch.Tensor  # () bool — work list truncated
    # Padded [forms | weights | word | d-lo | d-hi | iota] rows when the
    # cull was given `gw`; None otherwise.
    table: Optional[torch.Tensor] = None

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


class RSortLayout(NamedTuple):
    """Sorted block layout of one cull: the sort, the group search and the
    slot scatter, which a frozen layout (`rsort_layout`) takes out of the
    step and builds once for many scan points."""

    perm: torch.Tensor  # (G,) int64 sorted position -> original row
    src: torch.Tensor  # (G_pad,) int64 padded slot -> sorted position; G = padding
    inv_perm: torch.Tensor  # (G,) int64 original row -> padded slot (G_pad = culled)
    n_groups: torch.Tensor  # () observed pattern groups


def _padded_rows(g: int, spec: RSortSpec) -> int:
    """Worst-case padded population: the row count plus one partial block
    per pattern group."""
    return _cdiv(g, spec.g_tile) * spec.g_tile + spec.max_groups * spec.g_tile


class CullGeometry(NamedTuple):
    """Per-Gaussian cull geometry of one camera (`_cull_geometry`)."""

    d: torch.Tensor  # (G,) f32 camera distance
    radius: torch.Tensor  # (G,) f32 cull radius, -1 for dead rows
    word: torch.Tensor  # (G,) int32 rect word, 0 when culled
    valid_g: torch.Tensor  # (G,) bool
    counts: torch.Tensor  # (T_ang,) int32 per-tile member counts
    key: torch.Tensor  # (G,) int32 the layout's sort key (`_sort_keys`)
    geom: torch.Tensor  # (G, 4) f32 padded-table columns [word | d-lo | d-hi | row]


def _cull_geometry(means, scales, alive, cam, theta, phi, r, spec: RSortSpec,
                   scaling_modifier: float = 1.0, slack: float = 0.0) -> CullGeometry:
    """The cull geometry of one camera; `word` is the int32 rect word, 0
    when the Gaussian is culled. `slack` (a distance) widens the radial
    in-window test only (`rsort_layout`). CPU tensors take the plain chain;
    CUDA tensors kernel L1 (`cull_geometry`), equal to it bit for bit."""
    ns = theta.shape[0]
    n_tt = _cdiv(ns, spec.t_theta)
    n_pt = _cdiv(ns, spec.t_phi)
    _, _, b_total = _rect_bits(n_tt, n_pt)
    if b_total > 23:
        raise ValueError(
            f"rect word needs {b_total} bits (> 23): it rides the padded table as "
            f"an f32, exact to 24 bits, at this tile grid ({n_tt}x{n_pt})"
        )
    if on_cpu(means, scales, alive, cam, theta, phi, r):
        return _cull_geometry_plain(means, scales, alive, cam, theta, phi, r, spec,
                                    scaling_modifier, slack)
    return _cull_geometry_launch(means, scales, alive, cam, theta, phi, r, spec,
                                 scaling_modifier, slack)


def _cull_geometry_launch(means, scales, alive, cam, theta, phi, r, spec: RSortSpec,
                          scaling_modifier: float, slack: float) -> CullGeometry:
    """L1 on CUDA tensors: every output in one launch (after a memset of
    the counts)."""
    ns, g = theta.shape[0], means.shape[0]
    n_tt, n_pt = _cdiv(ns, spec.t_theta), _cdiv(ns, spec.t_phi)
    b_t, b_p, b_total = _rect_bits(n_tt, n_pt)
    for name, t, shape in (("means", means, (g, 3)), ("scales", scales, (g, 3)),
                           ("alive", alive, (g,)), ("theta", theta, (ns,)),
                           ("phi", phi, (ns,)), ("r", r, (r.shape[0],))):
        check_tensor(t, name, torch.float32, shape)
    if cam.dtype != torch.float32 or tuple(cam.shape) != (3,) or not cam.is_cuda:
        raise ValueError(f"cam must be a (3,) float32 CUDA tensor, got {cam.dtype} "
                         f"{tuple(cam.shape)} on {cam.device}")
    f32 = dict(dtype=torch.float32, device=means.device)
    i32 = dict(dtype=torch.int32, device=means.device)
    out = CullGeometry(
        d=torch.empty(g, **f32), radius=torch.empty(g, **f32), word=torch.empty(g, **i32),
        valid_g=torch.empty(g, dtype=torch.bool, device=means.device),
        counts=torch.empty(n_tt * n_pt, **i32), key=torch.empty(g, **i32),
        geom=torch.empty((g, 4), **f32),
    )
    KERNELS["cull_geometry"].launch(
        ptr(means), ptr(scales), ptr(alive), ptr(cam), ptr(theta), ptr(phi), ptr(r),
        *(ptr(t) for t in out), cam.stride(0), g, ns, r.shape[0], spec.t_theta,
        spec.t_phi, n_tt, n_pt, b_t, b_p, _dq_bits(b_total),
        float(spec.sigma_cull * scaling_modifier), float(spec.margin), float(slack),
    )
    return out


def _cull_geometry_plain(means, scales, alive, cam, theta, phi, r, spec: RSortSpec,
                         scaling_modifier: float = 1.0, slack: float = 0.0) -> CullGeometry:
    """`_cull_geometry` in PyTorch: the footprints (`angular_footprints`),
    the per-tile counts, the rect word, the sort key and the geometry
    columns."""
    ns = theta.shape[0]
    n_tt = _cdiv(ns, spec.t_theta)
    n_pt = _cdiv(ns, spec.t_phi)
    g = means.shape[0]
    d, radius, m_th, m_ph, in_window = angular_footprints(
        means, scales, alive, cam, theta, phi, r, spec, scaling_modifier
    )
    if slack:
        in_window = ((d - radius - slack <= r[-1]) & (d + radius + slack >= r[0])
                     & (radius >= 0.0))
    mask = (m_th[:, :, None] & m_ph[:, None, :] & in_window[:, None, None])
    counts = mask.reshape(g, n_tt * n_pt).sum(dim=0, dtype=torch.int32)

    b_t, b_p, _ = _rect_bits(n_tt, n_pt)
    idx_t = torch.arange(n_tt, dtype=torch.int32, device=means.device)
    idx_p = torch.arange(n_pt, dtype=torch.int32, device=means.device)
    th_lo_i = torch.where(m_th, idx_t[None, :], n_tt).amin(dim=1)
    th_hi_i = torch.where(m_th, idx_t[None, :], -1).amax(dim=1)
    ph_lo_i = torch.where(m_ph, idx_p[None, :], n_pt).amin(dim=1)
    ph_hi_i = torch.where(m_ph, idx_p[None, :], -1).amax(dim=1)
    valid_g = (th_hi_i >= th_lo_i) & (ph_hi_i >= ph_lo_i) & in_window
    tl = torch.clamp(th_lo_i, 0, n_tt - 1)
    th = torch.clamp(th_hi_i, 0, n_tt - 1)
    pll = torch.clamp(ph_lo_i, 0, n_pt - 1)
    phh = torch.clamp(ph_hi_i, 0, n_pt - 1)
    word = (((((1 << b_t) | tl) << b_t | th) << b_p | pll) << b_p) | phh
    word = torch.where(valid_g, word, 0).to(torch.int32)
    return CullGeometry(d, radius, word, valid_g, counts,
                        _sort_keys(d, word, valid_g, n_tt, n_pt, r[-1]),
                        _geom_columns(d, radius, word))


def _dq_bits(b_total: int) -> int:
    """Bits of the quantised distance below the rect word in the sort key."""
    return min(max(30 - (b_total + 1), 6), 16)


def _sort_keys(d, word, valid_g, n_tt: int, n_pt: int, d_hi):
    """(G,) int32 layout sort keys: the rect word (1 << b_total when culled)
    times 2^dq_bits plus d quantised over [0, d_hi]."""
    _, _, b_total = _rect_bits(n_tt, n_pt)
    dq_bits = _dq_bits(b_total)
    d_span = torch.clamp(d_hi, min=1e-6)
    dq = torch.clamp(
        (d / d_span * ((1 << dq_bits) - 1)).to(torch.int32), 0, (1 << dq_bits) - 1
    )
    key_c = torch.where(valid_g, word, 1 << b_total).to(torch.int32)
    return key_c * (1 << dq_bits) + dq


def _geom_columns(d, radius, word):
    """(G, 4) f32 geometry columns of the padded table: [word | d - radius |
    d + radius | row]."""
    iota = torch.arange(d.shape[0], dtype=torch.float32, device=d.device)
    return torch.stack([word.to(torch.float32), d - radius, d + radius, iota], dim=1)


@torch.no_grad()
def rsort_layout(means, scales, alive, cam, theta, phi, r, spec: RSortSpec,
                 scaling_modifier: float = 1.0, slack: float = 0.0) -> RSortLayout:
    """The frozen block layout of a reference camera `cam` (its grid
    theta, phi, r): `slack` must cover the largest distance from `cam` to
    any scan point the layout serves, plus the parameters' drift until the
    next rebuild. It widens only the radial window, so more slack costs a
    few layout rows; a Gaussian beyond it that a scan point sees raises
    that render's overflow flag (`rsort_cull`)."""
    ns = theta.shape[0]
    g = means.shape[0]
    if _padded_rows(g, spec) >= (1 << 24):
        raise ValueError(
            f"rsort padded rows {_padded_rows(g, spec)} >= 2^24: the padded "
            "table's iota column (full_perm) is an f32, exact to 24 bits; shrink "
            "max_groups or g_tile"
        )
    geo = _cull_geometry(
        means.detach(), scales.detach(), alive, cam, theta, phi, r, spec,
        scaling_modifier, slack,
    )
    return _layout_from_geometry(geo.d, geo.word, geo.valid_g, _cdiv(ns, spec.t_theta),
                                 _cdiv(ns, spec.t_phi), spec, d_hi=r[-1], key=geo.key)


L2_TILE_ROWS = 1024  # sorted rows a CTA of L2's change pass (`csrc/cull_layout.cu`)
_L2_TABLE_BYTES = 46 * 1024  # L2's group table in shared memory


def _layout_from_geometry(d, word, valid_g, n_tt: int, n_pt: int,
                          spec: RSortSpec, d_hi, key=None) -> RSortLayout:
    """Stable (word, quantized d) sort + block-aligned group layout. `key`
    is `_sort_keys(d, word, valid_g, n_tt, n_pt, d_hi)` where the caller has
    it (`_cull_geometry`'s). After the library's stable sort, CPU tensors
    take the plain chain (`_layout_plain`); CUDA tensors kernel L2
    (`cull_layout`), equal to it bit for bit."""
    if key is None:
        key = _sort_keys(d, word, valid_g, n_tt, n_pt, d_hi)
    packed_s, perm = torch.sort(key, stable=True)
    _, _, b_total = _rect_bits(n_tt, n_pt)
    if on_cpu(packed_s, perm):
        return _layout_plain(packed_s, perm, b_total, spec)
    return _layout_launch(packed_s, perm, b_total, spec)


def _layout_launch(packed_s, perm, b_total: int, spec: RSortSpec) -> RSortLayout:
    """L2 on the sorted keys (G,) int32 and their rows (G,) int64."""
    g = packed_s.shape[0]
    check_tensor(packed_s, "sorted keys", torch.int32, (g,))
    check_tensor(perm, "perm", torch.int64, (g,))
    if 12 * spec.max_groups > _L2_TABLE_BYTES:
        raise ValueError(
            f"cull_layout keeps {spec.max_groups} groups' table ({12 * spec.max_groups} "
            f"bytes) in shared memory, at most {_L2_TABLE_BYTES}: shrink max_groups"
        )
    dev = packed_s.device
    i64 = dict(dtype=torch.int64, device=dev)
    scratch = torch.empty(_cdiv(g, L2_TILE_ROWS) * spec.max_groups + 1, dtype=torch.int32,
                          device=dev)
    out = RSortLayout(perm=perm, src=torch.empty(_padded_rows(g, spec), **i64),
                      inv_perm=torch.empty(g, **i64), n_groups=torch.empty((), **i64))
    KERNELS["cull_layout"].launch(
        ptr(packed_s), ptr(perm), ptr(scratch), ptr(out.src), ptr(out.inv_perm),
        ptr(out.n_groups), g, out.src.shape[0], spec.g_tile, spec.max_groups,
        _dq_bits(b_total), 1 << b_total,
    )
    return out


def _layout_plain(packed_s, perm, b_total: int, spec: RSortSpec) -> RSortLayout:
    """The layout from the sorted keys in PyTorch. Integer gathers and
    `searchsorted` take the place of the JAX version's one-hot and stair
    matmuls; the values are the same."""
    g = packed_s.shape[0]
    dev = packed_s.device
    key_s = packed_s >> _dq_bits(b_total)
    valid_s = key_s < (1 << b_total)
    words_s = torch.where(valid_s, key_s, 0)

    iota = torch.arange(g, device=dev)
    false1 = torch.zeros(1, dtype=torch.bool, device=dev)
    change = torch.cat([false1, words_s[1:] != words_s[:-1]])
    raw_gid = torch.cumsum(change.to(torch.int64), dim=0)
    n_groups = torch.amax(torch.where(valid_s, raw_gid, -1)) + 1
    gid = torch.clamp(raw_gid, max=spec.max_groups - 1)
    eff_change = torch.cat([false1, gid[1:] != gid[:-1]])
    seg_start = torch.cummax(torch.where(eff_change, iota, 0), dim=0).values
    pos = iota - seg_start
    n_valid = valid_s.sum()
    group_ids = torch.arange(spec.max_groups, device=dev)
    right = torch.clamp(torch.searchsorted(gid, group_ids, right=True), max=n_valid)
    left = torch.clamp(torch.searchsorted(gid, group_ids), max=n_valid)
    cnt_g = right - left
    padded_g = (cnt_g + spec.g_tile - 1) // spec.g_tile * spec.g_tile
    start_g = torch.cumsum(padded_g, dim=0) - padded_g

    g_pad = _padded_rows(g, spec)
    dest = torch.where(valid_s, start_g[gid] + pos, g_pad)
    # Padded slot -> sorted row: each padded block belongs to the last group
    # whose start is at or before it (groups are g_tile-padded).
    kb = g_pad // spec.g_tile
    blk_start = torch.arange(kb, device=dev) * spec.g_tile
    k_of_b = torch.searchsorted(start_g, blk_start, right=True) - 1
    off_bt = (
        blk_start[:, None] + torch.arange(spec.g_tile, device=dev)[None, :]
        - start_g[k_of_b][:, None]
    )
    src_raw = left[k_of_b][:, None] + off_bt
    src = torch.where(off_bt < cnt_g[k_of_b][:, None], src_raw, g).reshape(g_pad)
    inv_perm = torch.empty_like(perm)
    inv_perm[perm] = dest
    return RSortLayout(perm=perm, src=src, inv_perm=inv_perm, n_groups=n_groups)


class WidePadGather(torch.autograd.Function):
    """Differentiable columns `gw` + constant geometry columns `geom` through
    the sort permutation then the padded block map, as one row gather pair.
    Padding slots (src == G) read a zero row. The backward is the inverse
    permutation gather: original row j gets `grad[inv_perm[j], :n_diff]`,
    culled rows (inv_perm >= G_pad) get zero. CPU tensors take the plain
    concatenations and gathers; CUDA tensors kernel L3 (`wide_gather_fwd`,
    `wide_gather_bwd`), one launch each way."""

    @staticmethod
    def forward(ctx, gw, geom, perm, src, inv_perm):
        ctx.save_for_backward(inv_perm)
        ctx.n_diff = gw.shape[1]
        if on_cpu(gw, geom, perm, src):
            return _wide_gather_plain(gw, geom, perm, src)
        return _wide_gather_launch(gw, geom, perm, src)

    @staticmethod
    def backward(ctx, grad):
        (inv_perm,) = ctx.saved_tensors
        if on_cpu(grad, inv_perm):
            dgw = _wide_gather_bwd_plain(grad, inv_perm, ctx.n_diff)
        else:
            dgw = _wide_gather_bwd_launch(grad.contiguous(), inv_perm, ctx.n_diff)
        return dgw, None, None, None, None


def _wide_gather_launch(gw, geom, perm, src):
    """L3's forward: the padded (G_pad, n_gw + n_geom) rows in one launch."""
    g, g_pad = gw.shape[0], src.shape[0]
    check_tensor(gw, "gw", torch.float32, (g, gw.shape[1]))
    check_tensor(geom, "geom", torch.float32, (g, geom.shape[1]))
    check_tensor(perm, "perm", torch.int64, (g,))
    check_tensor(src, "src", torch.int64, (g_pad,))
    out = torch.empty((g_pad, gw.shape[1] + geom.shape[1]), dtype=torch.float32,
                      device=gw.device)
    KERNELS["wide_gather_fwd"].launch(ptr(gw), ptr(geom), ptr(perm), ptr(src), ptr(out),
                                      g, g_pad, gw.shape[1], geom.shape[1])
    return out


def _wide_gather_bwd_launch(grad, inv_perm, n_diff: int):
    """L3's backward: (G, n_diff) rows of `grad` through `inv_perm` in one
    launch."""
    g, (g_pad, ld) = inv_perm.shape[0], grad.shape
    check_tensor(grad, "grad", torch.float32)
    check_tensor(inv_perm, "inv_perm", torch.int64, (g,))
    dgw = torch.empty((g, n_diff), dtype=torch.float32, device=grad.device)
    KERNELS["wide_gather_bwd"].launch(ptr(grad), ptr(inv_perm), ptr(dgw), g, g_pad, ld,
                                      n_diff)
    return dgw


def _wide_gather_plain(gw, geom, perm, src):
    """`WidePadGather`'s forward in PyTorch."""
    g = gw.shape[0]
    full = torch.cat([gw, geom], dim=1)
    full = torch.cat([full, full.new_zeros(1, full.shape[1])], dim=0)
    perm2 = torch.cat([perm, perm.new_full((1,), g)])
    return full[perm2][src]


def _wide_gather_bwd_plain(grad, inv_perm, n_diff: int):
    """`WidePadGather`'s backward in PyTorch."""
    g_pad = grad.shape[0]
    gz = torch.cat([grad[:, :n_diff], grad.new_zeros(1, n_diff)])
    return gz[torch.clamp(inv_perm, max=g_pad)]


class PadGather(torch.autograd.Function):
    """Rows `table[full_perm]` of a (G, F) table into the padded layout
    (slots >= G read zeros), with the inverse gather as the backward:
    original row j gets `grad[inv_perm[j]]`, zero where inv_perm >= G_pad
    (a row this camera culls, or one the layout has no slot for). Padding
    slots carry index 0 and word 0: the kernels gate them out and their
    cotangent rows are never read back."""

    @staticmethod
    def forward(ctx, table, full_perm, inv_perm):
        g = table.shape[0]
        ctx.save_for_backward(inv_perm)
        full = torch.cat([table, table.new_zeros(1, table.shape[1])])
        return full[torch.clamp(full_perm, max=g)]

    @staticmethod
    def backward(ctx, grad):
        (inv_perm,) = ctx.saved_tensors
        gz = torch.cat([grad, grad.new_zeros(1, grad.shape[1])])
        return gz[torch.clamp(inv_perm, max=grad.shape[0])], None, None


pad_gather = PadGather.apply  # JAX's `fused_rsort.pad_gather`


# --- kernels -----------------------------------------------------------------


# K1 ---------------------------------------------------------------------------


def cull_reduce(table, col: int, g_tile: int, r, n_tt: int, n_pt: int,
                total_bins: int):
    """Per-(block, tile) absolute active-bin ranges, read from the padded table.

    table (G_pad, n) f32 padded rows (`WidePadGather`'s output, read in
    place): columns col, col + 1, col + 2 hold each row's rect word (exact in
    f32: `_cull_geometry` refuses words over 23 bits), d - radius and
    d + radius; r (num_r,) f32 radii. Returns (words (G_pad,) int32,
    abs_lo, abs_hi (KB, T_ang) int32): bin a is active for the pair iff the
    union of its members' intervals, widened by half a bin and 1e-4 bin,
    holds r0 + a*dr. Empty pairs and pairs outside the bins encode
    (total_bins, -1).
    """
    if on_cpu(table, r):
        return _cull_reduce_plain(table, col, g_tile, r, n_tt, n_pt, total_bins)
    g_pad, n_col = table.shape
    check_tensor(table, "table", torch.float32)
    check_tensor(r, "r", torch.float32)
    if col + 3 > n_col:
        raise ValueError(f"table has {n_col} columns, K1 reads {col}..{col + 2}")
    if g_tile < 1 or g_pad % g_tile:
        raise ValueError(f"g_tile={g_tile} does not divide the table's {g_pad} rows")
    if r.numel() < 2:
        raise ValueError("need at least two radial bins")
    kb = g_pad // g_tile
    b_t, b_p, _ = _rect_bits(n_tt, n_pt)
    words = torch.empty(g_pad, dtype=torch.int32, device=table.device)
    abs_lo = torch.empty((kb, n_tt * n_pt), dtype=torch.int32, device=table.device)
    abs_hi = torch.empty_like(abs_lo)
    KERNELS["cull_reduce"].launch(
        ptr(table), n_col, col, ptr(r), ptr(words), ptr(abs_lo), ptr(abs_hi),
        kb, g_tile, n_tt, n_pt, b_t, b_p, total_bins,
    )
    return words, abs_lo, abs_hi


def _cull_reduce_plain(table, col, g_tile, r, n_tt, n_pt, total_bins):
    kb = table.shape[0] // g_tile
    words = table[:, col].to(torch.int32)
    lo = table[:, col + 1].reshape(kb, g_tile)
    hi = table[:, col + 2].reshape(kb, g_tile)
    memb = decode_rect_members(words, n_tt, n_pt).reshape(kb, g_tile, -1)
    inf = torch.tensor(float("inf"), dtype=lo.dtype, device=lo.device)
    blk_lo = torch.where(memb, lo[:, :, None], inf).amin(dim=1)
    blk_hi = torch.where(memb, hi[:, :, None], -inf).amax(dim=1)
    r0 = r[0]
    dr = r[1] - r[0]
    raw_lo = torch.ceil((blk_lo - r0) / dr - 0.5 - 1e-4)
    raw_hi = torch.floor((blk_hi - r0) / dr + 0.5 + 1e-4)
    valid = (blk_lo <= blk_hi) & (raw_hi >= 0) & (raw_lo <= total_bins - 1)
    abs_lo = torch.where(
        valid, torch.clamp(raw_lo, 0, total_bins - 1).to(torch.int32), total_bins
    )
    abs_hi = torch.where(
        valid, torch.clamp(raw_hi, 0, total_bins - 1).to(torch.int32), -1
    )
    return words, abs_lo, abs_hi


# K2 ---------------------------------------------------------------------------

K2_THREADS = 1024  # one CTA builds the lists (`csrc/build_work_lists.cu`)
_SMEM_OPTIN = 232448  # an H100 CTA's shared memory limit (227 KB)


class WorkLists(NamedTuple):
    """Every output of the schedule K2 writes (the `RSortTiles` fields)."""

    bwd: torch.Tensor  # (6, W) int32, block-major; zero past n_items
    fwd: torch.Tensor  # (6, W) int32, stable by (tile, chunk, block); zero past n_items
    n_raw: torch.Tensor  # (1,) int32 UNCLIPPED item count
    n_items: torch.Tensor  # (1,) int32 min(n_raw, W)
    tile_has_work: torch.Tensor  # (T_ang, n_ch) bool, written items only
    blk_has_work: torch.Tensor  # (KB,) bool, written items only
    overflowed: torch.Tensor  # () bool, n_raw > W


def _split_warps(nq: int, smem_limit: int) -> int:
    """The warps of K2's multi-split: the most (up to 32, a power of two)
    whose (bucket, warp) counters and bucket starts fit in `smem_limit`
    bytes; 0 when not even one warp's do."""
    split = K2_THREADS // 32
    while split and 4 * (nq * split + nq + 1) > smem_limit:
        split //= 2
    return split


def build_work_lists(abs_lo, abs_hi, n_ch: int, t_chunk: int, w: int) -> WorkLists:
    """Expand (block, tile) bin ranges into the two work lists.

    abs_lo/abs_hi (KB, T_ang) int32 from `cull_reduce`. Each non-empty pair
    expands to one item per radial chunk its range touches: the backward
    list in pair (block-major) order, the forward list stably sorted by
    (tile, chunk, block). Only the first `w` items are written (overflow =
    n_raw > w); slots past them are zero, and the has-work flags mark the
    written items only. K2 writes every output itself: the wrapper fills
    nothing.
    """
    if on_cpu(abs_lo, abs_hi):
        return _build_work_lists_plain(abs_lo, abs_hi, n_ch, t_chunk, w)
    kb, t_ang = abs_lo.shape
    check_tensor(abs_lo, "abs_lo", torch.int32)
    check_tensor(abs_hi, "abs_hi", torch.int32, (kb, t_ang))
    if w < 1:
        raise ValueError(f"work-list capacity w={w} must be positive")
    dev = abs_lo.device
    limit = getattr(torch.cuda.get_device_properties(dev),
                    "shared_memory_per_block_optin", _SMEM_OPTIN) - 256
    nq = t_ang * n_ch
    split = _split_warps(nq, limit)
    if not split:
        raise ValueError(
            f"K2 needs {4 * (2 * nq + 1)} bytes of shared memory for {nq} buckets "
            f"({t_ang} tiles x {n_ch} radial chunks) at one warp; a CTA has "
            f"{limit}. Use fewer, larger radial chunks or angular tiles."
        )
    i32 = dict(dtype=torch.int32, device=dev)
    b8 = dict(dtype=torch.bool, device=dev)
    out = WorkLists(
        bwd=torch.empty((6, w), **i32), fwd=torch.empty((6, w), **i32),
        n_raw=torch.empty((1,), **i32), n_items=torch.empty((1,), **i32),
        tile_has_work=torch.empty((t_ang, n_ch), **b8),
        blk_has_work=torch.empty((kb,), **b8), overflowed=torch.empty((), **b8),
    )
    off = torch.empty((kb * t_ang,), **i32)  # scratch: each pair's first slot
    KERNELS["build_work_lists"].launch(
        ptr(abs_lo), ptr(abs_hi), kb, t_ang, n_ch, t_chunk, w, split,
        *(ptr(t) for t in out), ptr(off),
    )
    return out


def _build_work_lists_plain(abs_lo, abs_hi, n_ch, t_chunk, w) -> WorkLists:
    """The JAX XLA-fallback chain (`rsort_cull`'s prefix-sum expansion and
    argsort), with the kernel's has-work and zero-tail semantics."""
    kb, t_ang = abs_lo.shape
    dev = abs_lo.device
    lo = abs_lo.long().reshape(-1)
    hi = abs_hi.long().reshape(-1)
    valid = hi >= 0
    j_lo = torch.where(valid, lo // t_chunk, n_ch)
    j_hi = torch.where(valid, hi // t_chunk, -1)
    nch = torch.clamp(j_hi - j_lo + 1, min=0)
    n_raw = nch.sum()
    off = torch.cumsum(nch, dim=0) - nch
    pair_ids = torch.arange(nch.shape[0], device=dev)
    slot_of = torch.clamp(torch.where(nch > 0, off, w), max=w)
    pair_at = torch.zeros(w + 1, dtype=torch.int64, device=dev).scatter_reduce(
        0, slot_of, pair_ids, reduce="amax"
    )[:w]
    pair_slot = torch.cummax(pair_at, dim=0).values
    slots = torch.arange(w, device=dev)
    live = slots < n_raw
    bwd_b = pair_slot // t_ang
    bwd_t = pair_slot % t_ang
    bwd_j = torch.clamp(j_lo[pair_slot] + (slots - off[pair_slot]), 0, n_ch - 1)
    one = torch.ones(1, dtype=torch.int64, device=dev)
    bwd_first = torch.cat([one, (bwd_b[1:] != bwd_b[:-1]).long()])
    bwd_bl = torch.clamp(lo[pair_slot] - bwd_j * t_chunk, 0, t_chunk - 1)
    bwd_bh = torch.clamp(hi[pair_slot] - bwd_j * t_chunk, 0, t_chunk - 1)
    bwd = torch.stack([bwd_t, bwd_j, bwd_b, bwd_first, bwd_bl, bwd_bh])

    big = torch.iinfo(torch.int64).max
    fkey = torch.where(live, (bwd_t * n_ch + bwd_j) * kb + bwd_b, big)
    f_ord = torch.sort(fkey, stable=True).indices
    fwd = bwd[:, f_ord].clone()
    out_f = fwd[0] * n_ch + fwd[1]
    fwd[3] = torch.cat([one, (out_f[1:] != out_f[:-1]).long()])

    q = (bwd_t * n_ch + bwd_j)
    lv = live.long()
    tile_w = torch.zeros(t_ang * n_ch, dtype=torch.int64, device=dev).scatter_reduce(
        0, q, lv, reduce="amax"
    )
    blk_w = torch.zeros(kb, dtype=torch.int64, device=dev).scatter_reduce(
        0, bwd_b, lv, reduce="amax"
    )
    n_items = torch.clamp(n_raw, max=w)
    keep = slots < n_items
    i32 = torch.int32
    return WorkLists(
        bwd=(bwd * keep).to(i32), fwd=(fwd * keep).to(i32),
        n_raw=n_raw.reshape(1).to(i32), n_items=n_items.reshape(1).to(i32),
        tile_has_work=tile_w.reshape(t_ang, n_ch) > 0, blk_has_work=blk_w > 0,
        overflowed=n_raw > w,
    )


def _multisplit_plain(q, nq: int, split: int):
    """K2's placement arrays for items of buckets `q` (n,) in backward order:
    `split` warps take contiguous segments of whole 32-item rounds. Returns
    (seg (n,) each item's warp, base (nq, split) the first forward slot of
    warp k's items of bucket q, start (nq + 1,) each bucket's first slot);
    an item goes to base[q, seg] plus the number of earlier items of its
    segment in its bucket."""
    n = q.shape[0]
    rounds = _cdiv(n, 32)
    seg = torch.arange(n, device=q.device) // (32 * max(_cdiv(rounds, split), 1))
    cnt = torch.zeros(nq * split, dtype=torch.int64, device=q.device)
    cnt.index_add_(0, q.long() * split + seg, torch.ones_like(seg))
    base = (torch.cumsum(cnt, 0) - cnt).reshape(nq, split)
    start = torch.cat([base[:, 0], cnt.sum().reshape(1)])
    return seg, base, start


# K3 / K4 ----------------------------------------------------------------------


class RSortGeometry(NamedTuple):
    """Static shape facts the field kernels need."""

    n_tt: int
    n_pt: int
    n_ch: int
    t_chunk: int
    g_tile: int
    s_ang: int
    t_phi: int = 0  # rays a tile row (rays run theta-major); 0: not given

    @property
    def t_ang(self) -> int:
        return self.n_tt * self.n_pt


def _center_transform(gf, x0, y0, z0):
    """(..., 10) original-basis forms -> forms centred at (x0, y0, z0):
    A' = A, b' = b + 2 A x0, c' = c + b.x0 + x0^T A x0 (packed layout of
    `gmath.gaussian_quadratic_form`)."""
    g0, g1, g2, g3, g4, g5, g6, g7, g8, g9 = gf.unbind(-1)
    b0 = g6 + 2.0 * g0 * x0 + g3 * y0 + g4 * z0
    b1 = g7 + 2.0 * g1 * y0 + g3 * x0 + g5 * z0
    b2 = g8 + 2.0 * g2 * z0 + g4 * x0 + g5 * y0
    c = (
        g9
        + g6 * x0 + g7 * y0 + g8 * z0
        + g0 * x0 * x0 + g1 * y0 * y0 + g2 * z0 * z0
        + g3 * x0 * y0 + g4 * x0 * z0 + g5 * y0 * z0
    )
    return torch.stack([g0, g1, g2, g3, g4, g5, b0, b1, b2, c], dim=-1)


def _center_transform_t(dgp, x0, y0, z0):
    """Transpose of `_center_transform`: centred-basis cotangent ->
    original-basis cotangent."""
    d0, d1, d2, d3, d4, d5, d6, d7, d8, d9 = dgp.unbind(-1)
    return torch.stack(
        [
            d0 + 2.0 * x0 * d6 + x0 * x0 * d9,
            d1 + 2.0 * y0 * d7 + y0 * y0 * d9,
            d2 + 2.0 * z0 * d8 + z0 * z0 * d9,
            d3 + y0 * d6 + x0 * d7 + x0 * y0 * d9,
            d4 + z0 * d6 + x0 * d8 + x0 * z0 * d9,
            d5 + z0 * d7 + y0 * d8 + y0 * z0 * d9,
            d6 + x0 * d9,
            d7 + y0 * d9,
            d8 + z0 * d9,
            d9,
        ],
        dim=-1,
    )


# K3 / K4 work units (K5 / K6 in `fused_analytic.py` build the same) -----------
#
# The field kernels split the work lists into units of bounded size, so no
# CTA carries much more than the mean (an item of the backward list can
# span a whole 200-bin chunk, a tile of the forward list can hold 100+
# items). Each kernel builds its schedule on the device (no host read, a
# static capacity); the plain builders below compute the same arrays.

BWD_UNIT_BINS = 8  # K4: at most this many bins of one item per unit
FWD_GROUP_ITEMS = 2  # K3: at most this many items of one tile per unit
FWD_SLICE = 256  # K3: samples per unit (one per thread)
_DEAD_KEY = (1 << 31) - 1


def bwd_unit_capacity(w: int, t_chunk: int, unit_bins: int) -> int:
    """Static bound on the K4 units of a W-item backward list."""
    return w * _cdiv(t_chunk, unit_bins)


def _bwd_unit_offsets_plain(bwd, n_items, unit_bins: int):
    """(W + 1,) int32 exclusive prefix of each backward item's unit count
    ceil((bh - bl + 1) / unit_bins), 0 past `n_items`; the last entry is
    the unit total. Unit u with off[i] <= u < off[i + 1] covers bins
    [bl + k U, min(bl + (k + 1) U - 1, bh)] of item i, k = u - off[i]."""
    w = bwd.shape[1]
    live = torch.arange(w, device=bwd.device) < n_items.to(bwd.device)[0]
    cnt = torch.where(live, (bwd[5] - bwd[4] + unit_bins) // unit_bins, 0).long()
    return torch.cat([cnt.new_zeros(1), torch.cumsum(cnt, 0)]).to(torch.int32)


def bwd_units(unit_off, bwd, unit_bins: int):
    """(item, bin_lo, bin_hi) int64 of every K4 unit, in unit order."""
    off = unit_off.long()
    cnt = off[1:] - off[:-1]
    item = torch.repeat_interleave(torch.arange(cnt.shape[0], device=off.device), cnt)
    lo = bwd[4].long()[item] + (torch.arange(item.shape[0], device=off.device)
                                - off[item]) * unit_bins
    return item, lo, torch.minimum(lo + unit_bins - 1, bwd[5].long()[item])


def fwd_group_capacity(w: int, t_tot: int, group_items: int) -> int:
    """Static bound on the K3 item groups of a W-item forward list: every
    non-empty tile adds at most one partial group."""
    return _cdiv(w, group_items) + min(t_tot, w)


def _fwd_groups_plain(fwd, n_items, geo: RSortGeometry, group_items: int,
                      slab_bins: int | None = None):
    """(6, G + 1) int32 schedule of K3 (`slab_bins` None) or K5, G =
    `fwd_group_capacity`.

    Each tile's items (contiguous in the forward list) are cut into groups
    of `group_items` consecutive items from the tile's first. Column g < n
    groups holds [first item, end item, key = t * n_ch + j, first position,
    last position, unit offset]: for K3 the slices (FWD_SLICE samples) the
    group's bins touch, one unit each; for K5 the group's bins [min bl,
    max bh], cut into units (slabs) of `slab_bins` bins from the first. The
    offsets are the exclusive prefix of the unit counts; units are (group,
    slice or slab) pairs in that order. Dead columns, and column G, hold
    [0, 0, 2^31 - 1, 0, -1, unit total]."""
    dev = fwd.device
    g_cap = fwd_group_capacity(fwd.shape[1], geo.t_ang * geo.n_ch, group_items)
    n = int(n_items[0])
    key = (fwd[0, :n].long() * geo.n_ch + fwd[1, :n].long())
    i = torch.arange(n, device=dev)
    heads = i[(i - torch.searchsorted(key, key)) % group_items == 0]
    end = torch.minimum(heads + group_items,
                        torch.searchsorted(key, key[heads], right=True))
    if slab_bins is None:
        s_lo = fwd[4, :n].long() * geo.s_ang // FWD_SLICE
        s_hi = ((fwd[5, :n].long() + 1) * geo.s_ang - 1) // FWD_SLICE
        span = 1
    else:
        s_lo, s_hi, span = fwd[4, :n].long(), fwd[5, :n].long(), slab_bins
    idx = heads[:, None] + torch.arange(group_items, device=dev)[None, :]
    inside = idx < end[:, None]
    idx = torch.clamp(idx, max=max(n - 1, 0))
    g_lo = torch.where(inside, s_lo[idx], 1 << 30).amin(1)
    g_hi = torch.where(inside, s_hi[idx], -1).amax(1)
    cnt = (g_hi - g_lo) // span + 1
    units = torch.cumsum(cnt, 0)
    total = int(units[-1]) if heads.numel() else 0
    ng = heads.shape[0]
    sched = torch.zeros((6, g_cap + 1), dtype=torch.int64, device=dev)
    sched[2] = _DEAD_KEY
    sched[4] = -1
    sched[5] = total
    for row, v in enumerate((heads, end, key[heads], g_lo, g_hi, units - cnt)):
        sched[row, :ng] = v
    return sched.to(torch.int32)


def fwd_units(sched, span: int = 1):
    """(group, first position) int64 of every K3 unit (span 1: its slice)
    or K5 unit (span U: its first bin), in unit order."""
    off = sched[5].long()
    cnt = off[1:] - off[:-1]
    group = torch.repeat_interleave(torch.arange(cnt.shape[0], device=off.device), cnt)
    k = torch.arange(group.shape[0], device=off.device) - off[group]
    return group, sched[3].long()[group] + k * span


def _field_args(xfeat, centers, table, words, lists, n_items, geo, c):
    t_tot, fdim, s = xfeat.shape
    if fdim != FDIM or s != geo.s_ang * geo.t_chunk:
        raise ValueError(f"xfeat shape {tuple(xfeat.shape)} does not match {geo}")
    if t_tot != geo.t_ang * geo.n_ch:
        raise ValueError(f"{t_tot} tiles, expected {geo.t_ang * geo.n_ch}")
    rows, f = table.shape
    if rows % geo.g_tile or words.shape[0] != rows:
        raise ValueError("table/words rows must be whole g_tile blocks")
    if not 1 <= c <= 2 or f < FDIM + c:
        raise ValueError(f"channel count {c} with table width {f}")
    check_tensor(xfeat, "xfeat", torch.float32)
    check_tensor(centers, "centers", torch.float32, (t_tot, 3))
    check_tensor(table, "table", torch.float32)
    check_tensor(words, "words", torch.int32)
    check_tensor(lists, "work list", torch.int32)
    check_tensor(n_items, "n_items", torch.int32, (1,))
    b_t, b_p, _ = _rect_bits(geo.n_tt, geo.n_pt)
    return (t_tot, s, geo.s_ang, geo.t_ang, geo.n_ch, geo.g_tile, f, c,
            lists.shape[1], geo.n_pt, b_t, b_p)


def rsort_fwd(xfeat, centers, table, words, fwd, n_items, geo: RSortGeometry,
              c: int):
    """Forward field over the forward work list: (T_tot, C, S) f32 with

        out[tile, c, s] = sum over the tile's items, over bins [bl, bh],
                          of sum_k w_c[k] * member[k] * exp(min(-q'_k(x_s)/2, 0))

    where q' is the block row's form centred at the tile centre. xfeat
    (T_tot, 10, S) centred monomials; table (KB*g_tile, F) rows
    [forms | weights (c) | ...]; words (KB*g_tile,) int32; fwd (6, W).
    Tiles with no items are zero. The TPU kernel's gate ladder covers up to
    gate_bins - 1 bins beyond [bl, bh]; their terms are below the cull
    cutoff, so covering exactly [bl, bh] is the same field.
    """
    if on_cpu(xfeat, centers, table, words, fwd, n_items):
        return _rsort_fwd_plain(xfeat, centers, table, words, fwd, n_items, geo, c)
    return _rsort_fwd_launch(xfeat, centers, table, words, fwd, n_items, geo, c)[0]


def _rsort_fwd_launch(xfeat, centers, table, words, fwd, n_items, geo, c):
    """K3 on CUDA tensors: (out, schedule). The schedule is the (6, G + 1)
    int32 array of `_fwd_groups_plain` as the kernel built it. Scratch at
    the bench scene (W 644, g_tile 256, 100 slices, G 330): the rows 7.9
    MB, the partial fields 34 MB, of which the live units (~2,900) touch
    3 MB; at W 12,288 (the largest re-fit there, see `_rsort_bwd_launch`)
    151 MB and 630 MB."""
    args = _field_args(xfeat, centers, table, words, fwd, n_items, geo, c)
    t_tot, _, s = xfeat.shape
    w = fwd.shape[1]
    g_cap = fwd_group_capacity(w, t_tot, FWD_GROUP_ITEMS)
    n_units = g_cap * _cdiv(s, FWD_SLICE)
    f32 = dict(dtype=torch.float32, device=xfeat.device)
    out = torch.empty((t_tot, c, s), **f32)
    # The schedule, then the unit -> group map.
    sched = torch.empty(6 * (g_cap + 1) + n_units, dtype=torch.int32,
                        device=xfeat.device)
    rows = torch.empty((w, geo.g_tile, 12), **f32)
    partial = torch.empty((n_units, c, FWD_SLICE), **f32)
    KERNELS["rsort_fwd"].launch(
        ptr(xfeat), ptr(centers), ptr(table), ptr(words), ptr(fwd),
        ptr(n_items), ptr(out), ptr(sched), ptr(rows), ptr(partial), *args,
        FWD_SLICE, FWD_GROUP_ITEMS, g_cap,
    )
    return out, sched[:6 * (g_cap + 1)].reshape(6, g_cap + 1)


def rsort_bwd(xfeat, centers, table, words, bwd, n_items, go, geo: RSortGeometry,
              c: int):
    """Cotangent of `rsort_fwd` with respect to the table: (KB*g_tile, F)
    f32, nonzero only in the form and weight columns of member rows.

    Per item of the block-major backward list, Z_c = p (go_c * x)^T over the
    item's bins; dg' = -1/2 sum_c w_c Z_c mapped back by
    `_center_transform_t`, and dw_c = Z_c[:, 9], both masked by membership.
    Like the TPU kernel it drops the m > 0 clamp mask on the cotangent.
    """
    if on_cpu(xfeat, centers, table, words, bwd, n_items, go):
        return _rsort_bwd_plain(xfeat, centers, table, words, bwd, n_items, go, geo, c)
    return _rsort_bwd_launch(xfeat, centers, table, words, bwd, n_items, go, geo, c)[0]


def _rsort_bwd_launch(xfeat, centers, table, words, bwd, n_items, go, geo, c):
    """K4 on CUDA tensors: (dtable, unit offsets). The offsets are the (W +
    1,) int32 array of `_bwd_unit_offsets_plain` as the kernel built it.
    The partial scratch is W * ceil(t_chunk / U) * g_tile * 40 C bytes,
    taken from the caching allocator on every call. At the bench scene (W
    644, t_chunk 200, U 8: 16,100 units) it is 165 MB at C = 1, of which the
    live units (~1,450) touch 15 MB. It grows with W: the largest W a
    grow-only re-fit can reach there (every one of 903 blocks in each of the
    8 tiles, x 1.25, bucketed: 12,288) gives 3.1 GB."""
    args = _field_args(xfeat, centers, table, words, bwd, n_items, geo, c)
    check_tensor(go, "go", torch.float32, (xfeat.shape[0], c, xfeat.shape[2]))
    w = bwd.shape[1]
    cap = bwd_unit_capacity(w, geo.t_chunk, BWD_UNIT_BINS)
    dtable = torch.empty_like(table)
    # Unit offsets, then the unit -> item map.
    units = torch.empty(w + 1 + cap, dtype=torch.int32, device=table.device)
    partial = torch.empty((cap, FDIM * c, geo.g_tile), dtype=torch.float32,
                          device=table.device)
    kb = table.shape[0] // geo.g_tile
    KERNELS["rsort_bwd"].launch(
        ptr(xfeat), ptr(centers), ptr(table), ptr(words), ptr(bwd),
        ptr(n_items), ptr(go), ptr(dtable), ptr(units), ptr(partial), *args,
        kb, BWD_UNIT_BINS, cap,
    )
    return dtable, units[:w + 1]


_PLAIN_BATCH_ELEMENTS = 1 << 25  # per (batch, g_tile, S) temporary: 128 MiB


def _item_batches(n: int, g_tile: int, s: int):
    """Item batches whose (batch, g_tile, S) temporaries stay within
    `_PLAIN_BATCH_ELEMENTS` elements."""
    nb = max(1, _PLAIN_BATCH_ELEMENTS // max(g_tile * s, 1))
    return [(i, min(i + nb, n)) for i in range(0, n, nb)]


def _items(xfeat, centers, table, words, lists, i0, i1, geo, c):
    """Gathered operands of work items [i0, i1): tile ids, centres, centred
    forms, raw weights, membership, monomial slabs and bin gates."""
    gt = geo.g_tile
    t, j, b = lists[0, i0:i1].long(), lists[1, i0:i1].long(), lists[2, i0:i1].long()
    bl, bh = lists[4, i0:i1], lists[5, i0:i1]
    tile = j * geo.t_ang + t
    cx = centers[tile]
    tab = table.reshape(-1, gt, table.shape[1])[b]  # (nb, gt, F)
    x0, y0, z0 = (cx[:, i, None] for i in range(3))
    g = _center_transform(tab[..., :FDIM], x0, y0, z0)
    memb = _member_of(words.reshape(-1, gt)[b], t[:, None], geo.n_tt, geo.n_pt)
    bins = torch.arange(xfeat.shape[2], device=xfeat.device) // geo.s_ang
    gate = (bins[None, :] >= bl[:, None]) & (bins[None, :] <= bh[:, None])
    return tile, (x0, y0, z0), g, tab[..., FDIM:FDIM + c], memb, xfeat[tile], gate, b


def _rsort_fwd_plain(xfeat, centers, table, words, fwd, n_items, geo, c):
    out = torch.zeros((xfeat.shape[0], c, xfeat.shape[2]), dtype=xfeat.dtype,
                      device=xfeat.device)
    n = int(n_items[0])
    for i0, i1 in _item_batches(n, geo.g_tile, xfeat.shape[2]):
        tile, _, g, w, memb, x, gate, _ = _items(
            xfeat, centers, table, words, fwd, i0, i1, geo, c
        )
        q = quad_form(g[:, :, None], x.transpose(1, 2)[:, None])  # (nb, gt, S)
        p = torch.exp(torch.clamp(-0.5 * q, max=0.0)) * gate[:, None, :]
        wm = (w * memb[..., None]).transpose(1, 2)  # (nb, C, gt)
        out.index_add_(0, tile, wm @ p)
    return out


def _rsort_bwd_plain(xfeat, centers, table, words, bwd, n_items, go, geo, c):
    gt = geo.g_tile
    dtable = torch.zeros_like(table)
    n = int(n_items[0])
    ar = torch.arange(gt, device=table.device)
    for i0, i1 in _item_batches(n, gt, xfeat.shape[2]):
        tile, (x0, y0, z0), g, w, memb, x, gate, b = _items(
            xfeat, centers, table, words, bwd, i0, i1, geo, c
        )
        q = quad_form(g[:, :, None], x.transpose(1, 2)[:, None])  # (nb, gt, S)
        p = torch.exp(torch.clamp(-0.5 * q, max=0.0)) * gate[:, None, :]
        gos = go[tile]
        zs = [p @ (gos[:, ci:ci + 1, :] * x).transpose(1, 2) for ci in range(c)]
        dgp = sum(-0.5 * w[..., ci:ci + 1] * zs[ci] for ci in range(c))
        mf = memb[..., None].to(table.dtype)
        dg = _center_transform_t(dgp, x0, y0, z0) * mf
        dw = torch.stack([z[..., FDIM - 1] for z in zs], dim=-1) * mf
        rows = (b[:, None] * gt + ar[None, :]).reshape(-1)
        upd = torch.zeros((rows.shape[0], table.shape[1]), dtype=table.dtype,
                          device=table.device)
        upd[:, :FDIM] = dg.reshape(-1, FDIM)
        upd[:, FDIM:FDIM + c] = dw.reshape(-1, c)
        dtable.index_add_(0, rows, upd)
    return dtable


class RSortField(torch.autograd.Function):
    """Work-list-sparse field (T_tot, C, S) of the padded table, with the
    K4 backward. Only `table` is differentiable."""

    @staticmethod
    def forward(ctx, table, xfeat, centers, words, fwd, bwd, n_items, geo, c):
        ctx.save_for_backward(xfeat, centers, table, words, bwd, n_items)
        ctx.geo, ctx.c = geo, c
        return rsort_fwd(xfeat, centers, table, words, fwd, n_items, geo, c)

    @staticmethod
    def backward(ctx, go):
        xfeat, centers, table, words, bwd, n_items = ctx.saved_tensors
        dtable = rsort_bwd(xfeat, centers, table, words, bwd, n_items,
                           go.contiguous(), ctx.geo, ctx.c)
        return (dtable,) + (None,) * 8


# --- cull + schedule ---------------------------------------------------------


def rsort_schedule(d, radius, word, valid_g, counts, r, n_tt: int, n_pt: int,
                   spec: RSortSpec, gw=None, layout: Optional[RSortLayout] = None,
                   key=None, geom=None) -> RSortTiles:
    """Layout, wide gather and work lists from per-Gaussian cull geometry
    (the half of `rsort_cull` after `_cull_geometry`).

    Without `layout` the sort builds this camera's; with one (a frozen
    `rsort_layout`) the step sorts and scatters nothing. Rows this camera
    culls keep their slots with word 0 and take the zero cotangent row
    (`inv_perm` = G_pad); a row this camera sees that the layout holds no
    slot for would be dropped, so it raises `overflowed` (the missed-slot
    flag). `key` and `geom` are `_cull_geometry`'s sort keys and geometry
    columns, computed here from the rest where the caller has none."""
    g = d.shape[0]
    g_pad = _padded_rows(g, spec)
    missed = None
    if layout is None:
        layout = _layout_from_geometry(d, word, valid_g, n_tt, n_pt, spec, d_hi=r[-1],
                                       key=key)
        inv_perm = layout.inv_perm
    else:
        inv_perm = torch.where(valid_g, layout.inv_perm, g_pad)
        missed = torch.any(valid_g & (layout.inv_perm >= g_pad))
    if geom is None:
        geom = _geom_columns(d, radius, word)
    per_row = WidePadGather.apply(
        geom.new_zeros(g, 0) if gw is None else gw, geom, layout.perm,
        layout.src, inv_perm,
    )
    n_gw = 0 if gw is None else gw.shape[1]
    full_perm, words, lists = _lists_from_rows(per_row.detach(), n_gw, r, n_tt,
                                               n_pt, spec)
    return RSortTiles(
        full_perm=full_perm,
        inv_perm=inv_perm,
        words=words[:, None],
        counts=counts,
        fwd=lists.fwd,
        bwd=lists.bwd,
        n_items=lists.n_items,
        tile_has_work=lists.tile_has_work,
        blk_has_work=lists.blk_has_work,
        n_groups=layout.n_groups,
        overflowed=lists.overflowed if missed is None else lists.overflowed | missed,
        table=None if gw is None else per_row,
    )


def _lists_from_rows(rows, n_gw: int, r, n_tt: int, n_pt: int, spec: RSortSpec):
    """What the schedule runs after the gather, on the padded rows [gw |
    word | d-lo | d-hi | iota]: the `full_perm` cast, K1 and K2, nothing
    else. Returns (full_perm, words, WorkLists)."""
    n_ch = _cdiv(r.shape[0], spec.t_chunk)
    full_perm = rows[:, n_gw + 3].to(torch.int64)
    words, abs_lo, abs_hi = cull_reduce(rows, n_gw, spec.g_tile, r, n_tt, n_pt,
                                        n_ch * spec.t_chunk)
    return full_perm, words, build_work_lists(abs_lo, abs_hi, n_ch, spec.t_chunk,
                                              spec.w_max)


def rsort_cull(means, scales, alive, cam, theta, phi, r, spec: RSortSpec,
               scaling_modifier: float = 1.0, gw=None,
               layout: Optional[RSortLayout] = None) -> RSortTiles:
    """Cull + schedule for one scan point.

    With `gw` ((G, FDIM + C) differentiable forms|weights), `tiles.table`
    holds the padded [forms | weights | word | d-lo | d-hi | iota] rows the
    field kernels read. The cull geometry itself carries no gradient.
    With `layout` (a frozen `rsort_layout`) the step runs no sort and no
    layout scatter: `_cull_geometry`, the wide gather, K1 and K2. Words and
    block intervals are this camera's, so the render is exact however
    stale the layout; a Gaussian this camera sees that the layout holds no
    slot for raises `overflowed` (the missed-slot flag; never with a fresh
    layout).
    """
    ns = theta.shape[0]
    with torch.no_grad():
        geo = _cull_geometry(
            means.detach(), scales.detach(), alive, cam, theta, phi, r, spec,
            scaling_modifier,
        )
    return rsort_schedule(
        geo.d, geo.radius, geo.word, geo.valid_g, geo.counts, r,
        _cdiv(ns, spec.t_theta), _cdiv(ns, spec.t_phi), spec, gw, layout,
        key=geo.key, geom=geo.geom,
    )


def _field_table(tiles: RSortTiles, gfeat, channel_weights, who: str):
    """The padded table the field kernels read, [forms | C weights | word |
    3 geometry]: the one the cull gathered (`rsort_cull(..., gw=...)`), or,
    for a cull without `gw`, forms|weights gathered into the layout here
    (`pad_gather`) beside the words and three zero columns (the kernels
    read forms and weights at the table's stride, not the geometry)."""
    n_forms, c = gfeat.shape[1], channel_weights.shape[1]
    table = tiles.table
    if table is None:
        gw_pad = pad_gather(torch.cat([gfeat, channel_weights], dim=1),
                            tiles.full_perm, tiles.inv_perm)
        words = tiles.words.to(gw_pad.dtype).detach()
        return torch.cat([gw_pad, words, gw_pad.new_zeros(gw_pad.shape[0], 3)], dim=1)
    if table.shape[1] - n_forms - c - 1 != 3:
        raise ValueError(
            f"{who}: tiles.table width {table.shape[1]} does not match "
            f"[{n_forms} forms | {c} weights | word | 3 geometry]"
        )
    return table


def rsort_gaussian_field(gfeat, channel_weights, tiles: RSortTiles,
                         spec: RSortSpec, grid, cam):
    """Work-list-sparse field (num_r, ns, ns, C) + overflow flag.

    With `tiles` from `rsort_cull(..., gw=cat([gfeat, channel_weights]))`
    the field reads the table the cull gathered, not `gfeat` itself; from a
    cull without `gw`, the table is gathered here (`_field_table`)."""
    table = _field_table(tiles, gfeat, channel_weights, "rsort_gaussian_field")
    return sampled_field(table, tiles, spec, grid, cam, channel_weights.shape[1]), \
        tiles.overflowed


def sampled_field(table, tiles, spec: RSortSpec, grid, cam, c: int):
    """K3 (and K4 in the backward) over `tiles`' lists on the padded
    `table` ([forms | C weights | word | 3 geometry]), untiled to (num_r,
    ns, ns, C): the field of `rsort_gaussian_field` and of the duplicated
    layout (`fused_dsort.dsort_gaussian_field`)."""
    num_r, ns = grid.r.shape[0], grid.theta.shape[0]
    n_tt = _cdiv(ns, spec.t_theta)
    n_pt = _cdiv(ns, spec.t_phi)
    n_ch = _cdiv(num_r, spec.t_chunk)
    if spec.t_chunk % spec.gate_bins:
        raise ValueError(
            f"gate_bins={spec.gate_bins} must divide t_chunk={spec.t_chunk}"
        )
    tp_spec = TileSpec(t_theta=spec.t_theta, t_phi=spec.t_phi, t_r=spec.t_chunk)
    with torch.no_grad():
        xfeat, centers = tile_points_centered_direct_t(
            grid.theta, grid.phi, grid.r, cam, tp_spec, n_tt, n_pt, n_ch
        )
    geo = RSortGeometry(n_tt, n_pt, n_ch, spec.t_chunk, spec.g_tile,
                        spec.t_theta * spec.t_phi)
    words = tiles.words.reshape(-1).contiguous()
    counter = profiling.device_counter("cull.listed_pairs", table.device)
    if counter is not None:
        listed_pairs(tiles.fwd, tiles.n_items, words, geo, counter)
    out = RSortField.apply(
        table, xfeat.contiguous(), centers.contiguous(), words, tiles.fwd, tiles.bwd,
        tiles.n_items, geo, c,
    )
    return untile_field_t(out, ns, num_r, tp_spec, n_tt, n_pt, n_ch)


@torch.no_grad()
def listed_pairs(fwd, n_items, words, geo: RSortGeometry, total) -> None:
    """Add to `total` ((1,) int64) the (member row, sample) pairs K3
    evaluates on the forward list fwd (6, W) with `n_items` (1,) int32 and
    the rect words (KB * g_tile,) int32: over the first n_items items, the
    rows of the item's block whose word covers its tile, times its bins
    (bh - bl + 1), times `geo.s_ang` (`tools/kernel_work.rsort_field_work`'s
    `pairs`). On the card one launch that reads n_items there, so a CUDA
    graph captures it; on the CPU the plain version."""
    if on_cpu(fwd, n_items, words, total):
        total += _listed_pairs_plain(fwd, n_items, words, geo)
        return
    w = fwd.shape[1]
    check_tensor(fwd, "fwd", torch.int32, (6, w))
    check_tensor(n_items, "n_items", torch.int32, (1,))
    check_tensor(words, "words", torch.int32)
    check_tensor(total, "total", torch.int64, (1,))
    if words.shape[0] % geo.g_tile:
        raise ValueError("words must be whole g_tile blocks")
    b_t, b_p, _ = _rect_bits(geo.n_tt, geo.n_pt)
    KERNELS["listed_pairs"].launch(ptr(fwd), ptr(n_items), ptr(words), ptr(total), w,
                                   geo.g_tile, geo.s_ang, geo.n_pt, b_t, b_p)


def _listed_pairs_plain(fwd, n_items, words, geo: RSortGeometry):
    """(1,) int64: `listed_pairs`' count, in PyTorch."""
    lists = fwd[:, :int(n_items[0])].long()
    memb = _member_of(words.reshape(-1, geo.g_tile)[lists[2]], lists[0][:, None],
                      geo.n_tt, geo.n_pt)
    return (memb.sum(1) * (lists[5] - lists[4] + 1) * geo.s_ang).sum().reshape(1)


@torch.no_grad()
def tune_rsort_spec(scene, camera_positions, box_points,
                    num_sampling_points: int, start: int, end: int, c: float,
                    delta_t: float, base: RSortSpec = RSortSpec(),
                    headroom: float = 1.25,
                    scaling_modifier: float = 1.0, ref_cam=None,
                    slack: float = 0.0) -> RSortSpec:
    """Fit `w_max` / `max_groups` to a scene by culling a few representative
    cameras with generous probe capacities. With `ref_cam` (frozen layouts)
    every probe is culled against one layout built from `ref_cam` with
    `slack` at the probe capacities, so the fitted `w_max` holds the looser
    blocks a frozen layout costs at the scan's corners."""
    from nlos_gaussian_renderer_tpu_torch.ops.sampling import shell_grid

    probe = probe_spec(base, scene.capacity, num_sampling_points, end - start)
    dev = scene.means.device
    cams = torch.as_tensor(camera_positions, dtype=torch.float32, device=dev)
    layout = None
    if ref_cam is not None:
        cam0 = torch.as_tensor(ref_cam, dtype=torch.float32, device=dev)
        grid0 = shell_grid(cam0, box_points, num_sampling_points, start, end, c,
                           delta_t)
        layout = rsort_layout(scene.means, scene.scales, scene.alive, cam0,
                              grid0.theta, grid0.phi, grid0.r, probe,
                              scaling_modifier, slack)
    max_items, max_groups_obs = 1, 1
    for cam in cams.reshape(-1, 3):
        grid = shell_grid(cam, box_points, num_sampling_points, start, end, c,
                          delta_t)
        t = rsort_cull(scene.means, scene.scales, scene.alive, cam,
                       grid.theta, grid.phi, grid.r, probe, scaling_modifier,
                       layout=layout)
        max_items = max(max_items, int(t.n_items[0]))
        max_groups_obs = max(max_groups_obs, int(t.n_groups))
    return base._replace(
        w_max=int(max_items * headroom) + 8,
        max_groups=min(max_groups_obs + max(4, max_groups_obs // 4), probe.max_groups),
    )


def probe_spec(base: RSortSpec, g: int, num_sampling_points: int,
               num_bins: int) -> RSortSpec:
    """The capacity `tune_rsort_spec` culls its probe cameras with: 4x the
    base's pattern groups (64 to 512) and a slot for every (block, tile,
    chunk) triple, so no probe overflows."""
    t_ang = _cdiv(num_sampling_points, base.t_theta) * _cdiv(
        num_sampling_points, base.t_phi
    )
    n_ch = _cdiv(num_bins, base.t_chunk)
    probe_groups = min(max(4 * base.max_groups, 64), 512)
    kb = _padded_rows(g, base._replace(max_groups=probe_groups)) // base.g_tile
    return base._replace(max_groups=probe_groups, w_max=max(kb * t_ang * n_ch, 1))
