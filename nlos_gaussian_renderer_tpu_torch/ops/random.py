"""Counter-based random draws keyed on a device step counter.

JAX's training draws are a pure function of `(seed, step)`:
`fold_in(PRNGKey(seed), step)`. That is what lets an overflow replay of a
chunk that densifies or adds SGLD noise repeat the run bit for bit. A
`torch.Generator` captured in a CUDA graph advances its offset on every
replay instead, so it would draw anew after the gate restores a snapshot.

The draws here are a hash of `(stream seed, step, row, lane)`: Chris
Wellons' `lowbias32` integer mix, applied in chain, in int64 tensor ops on
values below 2^32 (each 32-bit product split in 16-bit halves, so nothing
overflows). The step is read from its device tensor, so the same code runs
eagerly, inside a CUDA graph and on the CPU, and the host reads nothing.

Property: the same `(seed, step)` gives the same integer words, and so the
same uniforms (exact conversions), on every device and path. The draws
built on them may differ in the last bit between the CPU and the card:
the categorical's float64 CDF is summed in each device's order, and the
normals pass through f32 `log`, `sqrt` and `cos`. On one device, eager and
replayed draws are equal bit for bit.

These are not JAX's PRNG streams (threefry): the distributions are the
same, the draws are not. Tests that hold the port to JAX inject JAX's draws
(`models.densify.densify_step(draw=...)`, `train.sgld_position_noise(eps)`).
"""

from __future__ import annotations

import math

import torch

_MASK32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32), exact: no product
    reaches 2^49."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _mix32(x):
    """`lowbias32` on int64 tensors in [0, 2^32) or on Python ints."""
    if isinstance(x, int):
        x &= _MASK32
        x ^= x >> 16
        x = (x * 0x7FEB352D) & _MASK32
        x ^= x >> 15
        x = (x * 0x846CA68B) & _MASK32
        return x ^ (x >> 16)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def words(seed: int, step: torch.Tensor, rows: int, lanes: int, lane0: int = 0
          ) -> torch.Tensor:
    """(rows, lanes) int64 hash words in [0, 2^32) of (seed, step, row,
    lane0 + lane) on the step tensor's device. `step` is a 0-d integer
    tensor (the train state's counter), read on the device."""
    dev = step.device
    key = _mix32(_mix32(int(seed)) ^ 0x9E3779B9)
    s = _mix32((step.to(torch.int64) & _MASK32) ^ key)
    lane = torch.arange(lane0, lane0 + lanes, dtype=torch.int64, device=dev)
    s = _mix32(s ^ _mix32(lane + 0x632BE5AB))  # (lanes,)
    row = _mix32(torch.arange(rows, dtype=torch.int64, device=dev) ^ 0x85EBCA6B)
    return _mix32(row[:, None] ^ s[None, :])


def uniform64(seed: int, step: torch.Tensor, rows: int, lane: int) -> torch.Tensor:
    """(rows,) float64 uniforms in [0, 1) with 53 random bits, from the
    words of lanes 2 lane and 2 lane + 1."""
    w = words(seed, step, rows, 2, 2 * lane)
    return ((w[:, 0] >> 11) * 4294967296 + w[:, 1]).to(torch.float64) * 2.0**-53


def normal(seed: int, step: torch.Tensor, shape, dtype=torch.float32,
           lane0: int = 0) -> torch.Tensor:
    """Standard normals of `shape` (rows, cols) by Box-Muller on 24-bit
    uniforms: u1 in (0, 1], u2 in [0, 1), z = sqrt(-2 ln u1) cos(2 pi u2),
    column j from lanes lane0 + j (u1) and lane0 + cols + j (u2)."""
    rows, cols = shape
    w = words(seed, step, rows, 2 * cols, lane0) >> 8
    u1 = (w[:, :cols] + 1).to(dtype) * 2.0**-24
    u2 = w[:, cols:].to(dtype) * 2.0**-24
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)


def categorical(probs: torch.Tensor, seed: int, step: torch.Tensor,
                lane: int = 0) -> torch.Tensor:
    """(n,) int64 draws from the (n,) nonnegative weights `probs`, by
    inverse CDF: a float64 cumsum and `searchsorted` of n uniforms (lanes
    2 lane, 2 lane + 1). A row of weight 0 has zero width and is never
    drawn; a uniform that rounds up to the total goes to the last positive
    row. With no positive weight every draw is row 0 (callers mask their
    writes off, as JAX's `has_donors` does). O(n log n), no host read."""
    n = probs.shape[0]
    cdf = torch.cumsum(probs.to(torch.float64), dim=0)
    u = uniform64(seed, step, n, lane) * cdf[-1]
    idx = torch.searchsorted(cdf, u, right=True)
    rows = torch.arange(n, dtype=torch.int64, device=probs.device)
    last = torch.where(probs > 0, rows, torch.zeros_like(rows)).amax()
    return torch.minimum(idx, last)
