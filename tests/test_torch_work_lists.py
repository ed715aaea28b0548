"""The cull's work-list functions K1 (`cull_reduce`) and K2
(`build_work_lists`) through their plain versions (CPU tensors), against the
JAX package's Pallas kernels in interpret mode.

K1 reads the [word | d-lo | d-hi] columns of the padded table in place (a
strided view, as JAX's kernel reads views): it must equal the contiguous-
input reduction it replaced and JAX's `_block_ranges_pallas` packed words.
K2 must equal JAX's `_build_work_lists` on the valid prefix of both lists,
with its n_raw and has-work flags, at 1, 7 and 25 radial chunks, for an
empty list, a list exactly full, a list one item over capacity and one
block over every bin; its tails are zero. K2's multi-split placement (per-
warp bucket counters over contiguous segments, scanned in (bucket, warp)
order) is held to a stable sort. All exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlos_gaussian_renderer_tpu.ops import fused_rsort as jfr
from nlos_gaussian_renderer_tpu_torch.ops import fused_rsort as tfr
from test_torch_rsort import J_SPEC, T_SPEC, _jax_cull, both, scene_np

KB, T_ANG, T_CHUNK = 12, 4, 10


def _contiguous_ranges(words, lo, hi, r, n_tt, n_pt, total_bins):
    """K1's function on contiguous (KB, g_tile) words / lo / hi, tile by
    tile (the interface K1 had before it read the table)."""
    kb, gt = words.shape
    out_lo = torch.full((kb, n_tt * n_pt), total_bins, dtype=torch.int32)
    out_hi = torch.full((kb, n_tt * n_pt), -1, dtype=torch.int32)
    dr = r[1] - r[0]
    for t in range(n_tt * n_pt):
        m = tfr._member_of(words, t, n_tt, n_pt)
        for b in range(kb):
            if not bool(m[b].any()):
                continue
            raw_lo = torch.ceil((lo[b][m[b]].min() - r[0]) / dr - 0.5 - 1e-4)
            raw_hi = torch.floor((hi[b][m[b]].max() - r[0]) / dr + 0.5 + 1e-4)
            if raw_hi >= 0 and raw_lo <= total_bins - 1:
                out_lo[b, t] = int(raw_lo.clamp(0, total_bins - 1))
                out_hi[b, t] = int(raw_hi.clamp(0, total_bins - 1))
    return out_lo, out_hi


@pytest.mark.parametrize("n_gw", [0, 11])
@pytest.mark.parametrize("t_chunk", [8, 80])
def test_cull_reduce_reads_the_strided_table(n_gw, t_chunk):
    js, _ = both(scene_np(64, 21))
    spec = T_SPEC._replace(t_chunk=t_chunk)
    _, geom, grid = _jax_cull(js, J_SPEC._replace(t_chunk=t_chunk))
    d, radius, word, valid_g, counts = (torch.tensor(np.asarray(a)) for a in geom)
    r = torch.tensor(np.asarray(grid.r))
    gw = torch.randn((d.shape[0], n_gw), generator=torch.Generator().manual_seed(0))
    tiles = tfr.rsort_schedule(d, radius, word.to(torch.int32), valid_g, counts, r, 2, 1,
                               spec, gw=gw if n_gw else None)
    rows = tfr.WidePadGather.apply(gw, torch.stack(
        [word.float(), d - radius, d + radius, torch.arange(d.shape[0]).float()], 1),
        *_layout(d, word, valid_g, r, spec)).detach()
    assert not rows[:, n_gw].is_contiguous()
    n_ch = -(-r.shape[0] // t_chunk)
    tb = n_ch * t_chunk
    words, alo, ahi = tfr._cull_reduce_plain(rows, n_gw, spec.g_tile, r, 2, 1, tb)
    assert words.dtype == torch.int32 and torch.equal(words, tiles.words[:, 0])
    kb = rows.shape[0] // spec.g_tile
    ref = _contiguous_ranges(words.reshape(kb, -1), rows[:, n_gw + 1].reshape(kb, -1),
                             rows[:, n_gw + 2].reshape(kb, -1), r, 2, 1, tb)
    assert torch.equal(alo, ref[0]) and torch.equal(ahi, ref[1])
    assert bool((ahi >= 0).any()) and bool((ahi < 0).any())
    # JAX's K1 on the same table, interpret mode: packed (lo << ba | hi + 1)
    # and (chunk lo << bj | chunk hi + 1) words; empty pairs 0 and 1 << bj.
    w1, w2, ba, bj = jfr._block_ranges_pallas(
        jnp.asarray(rows.numpy()), n_gw, kb, J_SPEC._replace(t_chunk=t_chunk),
        jnp.asarray(r.numpy()), 2, 1, n_ch, interpret=True)
    ok = ahi >= 0
    a_lo, a_hi = alo.long(), ahi.long()
    p1 = torch.where(ok, (a_lo << ba) | (a_hi + 1), 0).reshape(-1)
    p2 = torch.where(ok, ((a_lo // t_chunk) << bj) | (a_hi // t_chunk + 1),
                     1 << bj).reshape(-1)
    np.testing.assert_array_equal(p1.numpy(), np.asarray(w1))
    np.testing.assert_array_equal(p2.numpy(), np.asarray(w2))


def _layout(d, word, valid_g, r, spec):
    lay = tfr._layout_from_geometry(d, word.to(torch.int32), valid_g, 2, 1, spec,
                                    d_hi=r[-1])
    return lay.perm, lay.src, lay.inv_perm


def _ranges(case, n_ch):
    """(abs_lo, abs_hi, w) int32 (KB, T_ANG) bin ranges of a case."""
    total = n_ch * T_CHUNK
    rng = np.random.default_rng(n_ch)
    lo = rng.integers(0, total, (KB, T_ANG))
    hi = np.minimum(lo + rng.integers(0, max(total // 3, 1), (KB, T_ANG)), total - 1)
    empty = rng.random((KB, T_ANG)) < 0.3
    lo[empty], hi[empty] = total, -1
    if case == "empty":
        lo[:], hi[:] = total, -1
    elif case == "one_block_all_bins":
        lo[5], hi[5] = 0, total - 1
    j_lo, j_hi = lo // T_CHUNK, np.where(hi >= 0, hi // T_CHUNK, -1)
    n_raw = int(np.maximum(j_hi - j_lo + 1, 0).sum())
    w = {"empty": 16, "full": n_raw, "over_by_one": n_raw - 1,
         "one_block_all_bins": n_raw + 8}[case]
    return torch.as_tensor(lo, dtype=torch.int32), torch.as_tensor(hi, dtype=torch.int32), w


CASES = ("empty", "full", "over_by_one", "one_block_all_bins")


@pytest.mark.parametrize("n_ch", [1, 7, 25])
@pytest.mark.parametrize("case", CASES)
def test_build_work_lists_matches_jax(case, n_ch):
    alo, ahi, w = _ranges(case, n_ch)
    got = tfr._build_work_lists_plain(alo, ahi, n_ch, T_CHUNK, w)
    total = n_ch * T_CHUNK
    ba, bj = total.bit_length(), n_ch.bit_length()
    ok = (ahi >= 0).long()
    a_lo, a_hi = alo.long(), ahi.long()
    w1 = ok * ((a_lo << ba) | (a_hi + 1))
    w2 = torch.where(ok > 0, ((a_lo // T_CHUNK) << bj) | (a_hi // T_CHUNK + 1), 1 << bj)
    ref = jfr._build_work_lists(
        jnp.asarray(w1.reshape(-1).int().numpy()), jnp.asarray(w2.reshape(-1).int().numpy()),
        ba, bj, KB, T_ANG, n_ch, J_SPEC._replace(t_chunk=T_CHUNK, w_max=w), interpret=True)
    n_raw = int(ref[12][0])
    n = min(n_raw, w)
    assert int(got.n_raw[0]) == n_raw and int(got.n_items[0]) == n
    assert bool(got.overflowed) == (n_raw > w) == (case == "over_by_one")
    assert (n == 0) == (case == "empty")
    if case == "one_block_all_bins":
        assert int((got.bwd[2, :n] == 5).sum()) == T_ANG * n_ch
    for k, lst in enumerate((got.bwd, got.fwd)):
        for f in range(6):
            np.testing.assert_array_equal(lst[f, :n].numpy(), np.asarray(ref[6 * k + f])[:n],
                                          err_msg=f"list {k} row {f}")
        assert bool((lst[:, n:] == 0).all())
    np.testing.assert_array_equal(got.tile_has_work.reshape(-1).numpy(),
                                  np.asarray(ref[13]) > 0)
    np.testing.assert_array_equal(got.blk_has_work.numpy(), np.asarray(ref[14]) > 0)
    assert got.tile_has_work.shape == (T_ANG, n_ch) and got.overflowed.shape == ()


@pytest.mark.parametrize("n,nq,split", [(0, 4, 32), (1, 4, 32), (31, 3, 2), (33, 3, 2),
                                        (1000, 200, 32), (1000, 7, 1), (517, 25, 8)])
def test_multisplit_placement_is_a_stable_sort(n, nq, split):
    q = torch.as_tensor(np.random.default_rng(n + nq).integers(0, nq, n))
    seg, base, start = tfr._multisplit_plain(q, nq, split)
    assert base.shape == (nq, split) and start.shape == (nq + 1,)
    if n:
        assert int(seg.max()) < split and bool((seg[1:] >= seg[:-1]).all())
    key = q * split + seg
    rank = torch.zeros(n, dtype=torch.int64)
    for k in torch.unique(key).tolist():  # earlier items of the same (bucket, warp)
        idx = torch.nonzero(key == k)[:, 0]
        rank[idx] = torch.arange(idx.shape[0])
    dest = base[q, seg] + rank
    assert torch.equal(torch.argsort(dest), torch.sort(q, stable=True).indices)
    assert torch.equal(start, torch.cat([torch.zeros(1, dtype=torch.int64),
                                         torch.cumsum(torch.bincount(q, minlength=nq), 0)]))


@pytest.mark.parametrize("n_ch", [1, 7, 25])
def test_multisplit_of_the_backward_list_gives_the_forward_list(n_ch):
    alo, ahi, w = _ranges("full", n_ch)
    got = tfr._build_work_lists_plain(alo, ahi, n_ch, T_CHUNK, w)
    n = int(got.n_items[0])
    q = got.bwd[0, :n].long() * n_ch + got.bwd[1, :n].long()
    seg, base, start = tfr._multisplit_plain(q, T_ANG * n_ch, 2)
    key = q * 2 + seg
    rank = torch.tensor([int((key[:i] == key[i]).sum()) for i in range(n)],
                        dtype=torch.int64)
    dest = base[q, seg] + rank
    fwd = torch.zeros_like(got.fwd[:, :n])
    fwd[:, dest] = got.bwd[:, :n]
    fwd[3] = (torch.arange(n) == start[fwd[0].long() * n_ch + fwd[1].long()]).int()
    assert torch.equal(fwd, got.fwd[:, :n])


def test_split_warps_fit_the_shared_memory():
    limit = tfr._SMEM_OPTIN - 256
    assert tfr._split_warps(200, limit) == 32  # ~26 KB of counters
    assert 4 * (200 * 32 + 201) < 27_000
    assert tfr._split_warps(2000, limit) == 16
    assert tfr._split_warps(29_000, limit) == 1
    assert tfr._split_warps(30_000, limit) == 0
