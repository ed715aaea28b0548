"""Does a unique-index row scatter cost scale with the row's width or with
the row count? The counterpart of the JAX repo's `tools/scatterbench.py`,
asked of the card.

Rows (G rows into G + 26 * 256, the rsort layout's padded population):
`index_copy_` of f32 (G,) and (G, 4 / 8 / 16) rows at a random unique
destination each, `scatter_` of the (G,) row, the s32 inverse-permutation
scatter, `torch.sort(stable=True)` with and without an int32 payload, and
JAX's counting-rank pipeline (one-hot words in blocks of 512, in-block
counts from a batched strictly-lower-triangular product, block offsets and
word starts from cumulative sums), held equal to a stable argsort's rank.
Each row is timed from a CUDA graph of 50 calls (`schedbench.graph_ms`).

    python -m nlos_gaussian_renderer_tpu_torch.tools.scatterbench [G]

The card only; prints one JSON line.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from nlos_gaussian_renderer_tpu_torch.tools import card_name, resolve_device

PAD_BLOCKS, G_TILE = 26, 256
NCOLS, BLOCK = 128, 512


def counting_rank(words: torch.Tensor, ncols: int = NCOLS, blk: int = BLOCK) -> torch.Tensor:
    """(G,) int32: each word's position in a stable sort of `words`
    (values in [0, ncols)), without a sort (JAX's pipeline,
    `scatterbench.py:96-127`). The counts are exact in f32 (at most `blk`
    a block, G in all), TF32 or not: the product's inputs are 0 and 1."""
    g = words.shape[0]
    nb = -(-g // blk)
    cols = torch.arange(ncols, dtype=words.dtype, device=words.device)
    oh = (words[:, None] == cols[None, :]).to(torch.float32)
    ohb = torch.nn.functional.pad(oh, (0, 0, 0, nb * blk - g)).reshape(nb, blk, ncols)
    blk_cnt = ohb.sum(dim=1)  # (nb, C)
    blk_off = torch.cumsum(blk_cnt, dim=0) - blk_cnt  # exclusive
    tril = torch.tril(torch.ones((blk, blk), dtype=torch.float32, device=words.device), -1)
    within = torch.bmm(tril.expand(nb, blk, blk), ohb)  # (nb, blk, C)
    rank = ((within + blk_off[:, None, :]) * ohb).sum(dim=2)
    tot = blk_cnt.sum(dim=0)
    start = torch.cumsum(tot, dim=0) - tot
    sel_start = (start[None, None, :] * ohb).sum(dim=2)
    return (rank + sel_start).reshape(-1)[:g].to(torch.int32)


def stable_rank(words: torch.Tensor) -> torch.Tensor:
    """The same rank through a stable argsort."""
    order = torch.sort(words, stable=True).indices
    rank = torch.empty_like(order)
    rank[order] = torch.arange(words.shape[0], device=words.device)
    return rank.to(torch.int32)


def run(g: int = 100_000, device="cuda") -> dict:
    from nlos_gaussian_renderer_tpu_torch.tools.schedbench import graph_ms

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("scatterbench times CUDA graphs: the card only")
    g_pad = g + PAD_BLOCKS * G_TILE
    rng = np.random.default_rng(0)
    perm = torch.as_tensor(rng.permutation(g).astype(np.int64), device=dev)
    dest = torch.as_tensor(rng.permutation(g_pad)[:g].astype(np.int64), device=dev)
    iota = torch.arange(g, dtype=torch.int32, device=dev)
    keys = torch.as_tensor(rng.integers(0, 1 << 23, g).astype(np.int32), device=dev)
    words = torch.as_tensor(rng.integers(64, 128, g).astype(np.int32), device=dev)
    rows = {}

    def row(name, fn):
        rows[name] = graph_ms(fn)

    v1 = torch.as_tensor(rng.standard_normal(g).astype(np.float32), device=dev)
    out1 = torch.zeros(g_pad, dtype=torch.float32, device=dev)
    row("index_copy_ f32 (G,)", lambda: out1.index_copy_(0, dest, v1))
    row("scatter_ f32 (G,)", lambda: out1.scatter_(0, dest, v1))
    for w in (4, 8, 16):
        vw = torch.as_tensor(rng.standard_normal((g, w)).astype(np.float32), device=dev)
        outw = torch.zeros((g_pad, w), dtype=torch.float32, device=dev)
        row(f"index_copy_ f32 (G,{w})", lambda vw=vw, outw=outw: outw.index_copy_(0, dest, vw))
    inv = torch.zeros(g, dtype=torch.int32, device=dev)
    row("inverse-permutation s32 scatter", lambda: inv.index_copy_(0, perm, iota))

    def sort_payload():
        order = torch.sort(keys, stable=True).indices
        return iota[order]

    row("sort stable key+payload", sort_payload)
    row("sort stable key only", lambda: torch.sort(keys, stable=True).values)
    row(f"counting rank {NCOLS} cols", lambda: counting_rank(words))
    rank_equal = bool(torch.equal(counting_rank(words), stable_rank(words)))
    return {"g": g, "g_pad": g_pad, "ms_graph": rows, "counting_rank_equals_stable_argsort":
            rank_equal, "device": torch.cuda.get_device_name(dev), "card": card_name(dev)}


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    out = run(int(argv[0]) if argv else 100_000)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
