"""The layout kernel's algorithm, spelled in PyTorch, against the plain chain.

`csrc/cull_layout.cu` (L2) builds the rsort layout from the sorted keys
without the chain's cummax and searchsorted passes: group k >= 1 starts at
the k-th change of word among the sorted rows (its position found by the
change pass's CTAs, each of `L2_TILE_ROWS` rows, which keep the positions
of their first max_groups - 1 changes), the valid rows are a prefix, and
each row's group and each padded block's group are binary searches of the
group table. `_layout_scan` below follows those steps tile by tile; it must
equal `fused_rsort._layout_plain` on every output: random keys with more
distinct words than groups (merged groups), every row culled, none culled,
changes on tile edges, one group, the probe's 512 groups. CPU only; the
kernel itself is held to the chain on the card
(tests/test_torch_cull_cuda.py)."""

import pytest
import torch

from nlos_gaussian_renderer_tpu_torch.ops import fused_rsort as fr

B_TOTAL = 11  # the rect word's bits at a 16 x 8 tile grid of 2 x 4 rays (b_t 4, b_p 3)
SPEC = fr.RSortSpec(g_tile=32, max_groups=16)


def _layout_scan(packed_s, perm, b_total: int, spec: fr.RSortSpec) -> fr.RSortLayout:
    """L2's steps in PyTorch: the change pass a tile at a time, then the
    group table and the two binary searches of the placement pass."""
    g = packed_s.shape[0]
    mg, n_pos, tile = spec.max_groups, spec.max_groups - 1, fr.L2_TILE_ROWS
    key = (packed_s >> fr._dq_bits(b_total)).tolist()
    culled = 1 << b_total
    part, pos, n_valid = [], [], None
    for a0 in range(0, g, tile):
        found = [i for i in range(max(a0, 1), min(a0 + tile, g)) if key[i] != key[i - 1]]
        part.append(len(found))
        pos.append(found[:n_pos])
        for i in range(a0, min(a0 + tile, g)):
            if key[i] >= culled and (i == 0 or key[i - 1] < culled):
                n_valid = i
            if key[i] < culled and i == g - 1:
                n_valid = g
    n_valid = n_valid if g else 0
    left = [0] + [n_valid] * n_pos
    run = 0
    for c, p in zip(part, pos):
        for q in range(c):
            if run + q < n_pos:
                left[run + q + 1] = p[q]
        run += c
    n_groups = 0 if n_valid == 0 else run + (1 if n_valid == g else 0)
    left_t = torch.tensor(left)
    cnt = torch.cat([left_t[1:], torch.tensor([n_valid])]) - left_t
    padded = (cnt + spec.g_tile - 1) // spec.g_tile * spec.g_tile
    start = torch.cumsum(padded, 0) - padded
    g_pad = fr._padded_rows(g, spec)
    rows = torch.arange(g)
    gid = torch.searchsorted(left_t[1:], rows, right=True)
    dest = torch.where(rows < n_valid, start[gid] + rows - left_t[gid], g_pad)
    inv_perm = torch.empty_like(perm)
    inv_perm[perm] = dest
    slots = torch.arange(g_pad)
    k = torch.searchsorted(start, slots - slots % spec.g_tile, right=True) - 1
    off = slots - start[k]
    src = torch.where(off < cnt[k], left_t[k] + off, g)
    return fr.RSortLayout(perm=perm, src=src, inv_perm=inv_perm,
                          n_groups=torch.tensor(n_groups))


def _keys(case: str, g: int, seed: int) -> torch.Tensor:
    """(G,) int32 layout keys: rect words (valid bit set) or the culled key,
    times 2^dq_bits, plus a quantised distance."""
    gen = torch.Generator().manual_seed(seed)
    dq_bits = fr._dq_bits(B_TOTAL)
    valid_word = lambda n, k: (1 << (B_TOTAL - 1)) + torch.randint(0, k, (n,), generator=gen)
    if case == "all_culled":
        word = torch.full((g,), 1 << B_TOTAL)
    elif case == "none_culled":
        word = valid_word(g, 40)
    elif case == "one_word":
        word = torch.where(torch.rand(g, generator=gen) < 0.7, 1 << (B_TOTAL - 1), 1 << B_TOTAL)
    elif case == "many_words":  # far more distinct words than groups: merged
        word = torch.where(torch.rand(g, generator=gen) < 0.8, valid_word(g, 900),
                           torch.tensor(1 << B_TOTAL))
    else:  # "few_words"
        word = torch.where(torch.rand(g, generator=gen) < 0.6, valid_word(g, 12),
                           torch.tensor(1 << B_TOTAL))
    dq = torch.randint(0, 1 << dq_bits, (g,), generator=gen)
    return (word * (1 << dq_bits) + dq).to(torch.int32)


@pytest.mark.parametrize("case,g,max_groups", [
    ("few_words", 5_000, 16), ("many_words", 5_000, 16), ("many_words", 3_073, 512),
    ("all_culled", 2_048, 16), ("none_culled", 2_049, 16), ("one_word", 1_500, 1),
    ("few_words", 1_023, 64), ("many_words", 1, 16),
])
def test_layout_scan_equals_the_chain(case, g, max_groups):
    spec = SPEC._replace(max_groups=max_groups)
    packed_s, perm = torch.sort(_keys(case, g, seed=g + max_groups), stable=True)
    ref = fr._layout_plain(packed_s, perm, B_TOTAL, spec)
    got = _layout_scan(packed_s, perm, B_TOTAL, spec)
    for f in ("src", "inv_perm"):
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
    assert int(got.n_groups) == int(ref.n_groups)


def test_layout_scan_with_changes_on_tile_edges():
    """Words that change exactly at rows 1023/1024 and 2047/2048 (the first
    row of a CTA of the change pass is compared with the last row of the
    one before), the culled tail starting on an edge."""
    tile = fr.L2_TILE_ROWS
    dq_bits = fr._dq_bits(B_TOTAL)
    word = torch.full((3 * tile + 5,), 1 << B_TOTAL)
    word[:tile] = 1 << (B_TOTAL - 1)
    word[tile:2 * tile] = (1 << (B_TOTAL - 1)) + 3
    word[2 * tile:3 * tile] = (1 << (B_TOTAL - 1)) + 4
    packed_s = (word * (1 << dq_bits)).to(torch.int32)
    perm = torch.randperm(word.shape[0], generator=torch.Generator().manual_seed(3))
    for mg in (2, 3, 16):
        spec = SPEC._replace(max_groups=mg)
        ref = fr._layout_plain(packed_s, perm, B_TOTAL, spec)
        got = _layout_scan(packed_s, perm, B_TOTAL, spec)
        assert torch.equal(got.src, ref.src) and torch.equal(got.inv_perm, ref.inv_perm)
        assert int(got.n_groups) == int(ref.n_groups) == 3
