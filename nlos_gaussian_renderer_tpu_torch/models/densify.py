"""MCMC-GS densification on a fixed-capacity, alive-masked scene (PyTorch).

Port of `nlos_gaussian_renderer_tpu/models/densify.py`: dead-Gaussian
relocation and capped growth with static shapes. The scene never changes
size; dead capacity slots are revived, and the Adam moments of rewritten
rows are zeroed by a mask.

Relocation is the binomial moment-matching rule of "3D Gaussian Splatting
as MCMC" (Kheradmand et al. 2024): N copies of a Gaussian of opacity o take
    o_new = 1 - (1 - o)^(1/N)
    s_new = s * o / sum_{i=1..N} sum_{k=0..i-1} C(i-1,k) (-1)^k o_new^{k+1}/sqrt(k+1).

Everything is written in place, under `no_grad`, into the scene's existing
parameters, its `alive` buffer and the optimizer's moment tensors: a CUDA
graph of `fit`'s chunk is bound to their storage. Shapes are fixed and the
host reads nothing (counts by `scatter_add_`, no `nonzero`, no boolean
indexing, no `.item()`), so one `densify_step` can be captured in a graph.

The donors are drawn by `ops.random.categorical` (inverse CDF), keyed on
`(seed, step)` with the step read from its device tensor, where JAX draws
by `jax.random.categorical` (a Gumbel argmax). The distributions are the
same; parity tests inject JAX's draws through `draw`.
"""

from __future__ import annotations

from math import comb
from typing import Callable, Optional

import numpy as np
import torch

from nlos_gaussian_renderer_tpu_torch.models.scene import GaussianScene
from nlos_gaussian_renderer_tpu_torch.ops import math as gmath
from nlos_gaussian_renderer_tpu_torch.ops import random as prng

# Maximum split multiplicity in the relocation rule (the MCMC-3DGS binomial
# table size; counts are clamped to this).
MAX_SPLIT = 51


def _relocation_tables(max_split: int = MAX_SPLIT) -> np.ndarray:
    """S[n, k] = sum_{i=k+1..n} C(i-1, k) (-1)^k / sqrt(k+1), so that
    denom(o_new, N) = sum_k S[N, k] * o_new^(k+1): float64, cast to f32."""
    t = np.zeros((max_split + 1, max_split), dtype=np.float64)
    for i in range(1, max_split + 1):
        for k in range(i):
            t[i, k] = comb(i - 1, k) * ((-1.0) ** k) / np.sqrt(k + 1.0)
    return np.cumsum(t, axis=0).astype(np.float32)  # S[n] = sum_{i<=n} t[i]


def compute_relocation(opacity_old: torch.Tensor, scale_old: torch.Tensor,
                       n: torch.Tensor):
    """The relocation rule on (M,) activated opacities, (M, 3) activated
    scales and (M,) integer split counts (clamped to [1, MAX_SPLIT]).
    Returns (new_opacity (M,), new_scale (M, 3)), in f32 as JAX's."""
    dev = opacity_old.device
    n = torch.clamp(n.to(torch.int64), 1, MAX_SPLIT)
    o_new = 1.0 - torch.pow(torch.clamp(1.0 - opacity_old, 1e-10, 1.0),
                            1.0 / n.to(torch.float32))
    table = gmath.device_constant("relocation_table", _relocation_tables, dev)
    exps = gmath.device_constant("relocation_exponents",
                                 lambda: np.arange(1, MAX_SPLIT + 1, dtype=np.float32), dev)
    powers = torch.pow(o_new[:, None], exps[None, :])
    denom = torch.sum(table[n] * powers, dim=-1)
    coeff = opacity_old / torch.clamp(denom, min=1e-12)
    return o_new, scale_old * coeff[:, None]


def _zero_param_rows(opt_state, mask: torch.Tensor) -> None:
    """Zero the masked rows (`mask` (cap,) float 0/1) of every Adam moment,
    in place: the port's `AdamState.mu` / `nu` (lists in `train.GROUPS`
    order). JAX writes `leaf * (1 - mask)` over every capacity-shaped float
    leaf; `count` is left alone."""
    keep = 1.0 - mask
    for t in list(opt_state.mu) + list(opt_state.nu):
        t.mul_(keep.reshape((-1,) + (1,) * (t.ndim - 1)).to(t.dtype))


def _copy_rows(scene: GaussianScene, donor_idx: torch.Tensor, write: torch.Tensor,
               new_logit_op: torch.Tensor, new_log_scale: torch.Tensor) -> None:
    """Overwrite the rows where `write` (cap,) bool holds with their donor's
    rows (`donor_idx` (cap,) int64), with the relocated opacity and scale."""
    w = write[:, None]
    for name in ("means", "quats", "sh_dc", "sh_rest"):
        x = getattr(scene, name)
        x.copy_(torch.where(w, x.index_select(0, donor_idx), x))
    scene.logit_opacities.copy_(
        torch.where(w, new_logit_op.index_select(0, donor_idx), scene.logit_opacities))
    scene.log_scales.copy_(
        torch.where(w, new_log_scale.index_select(0, donor_idx), scene.log_scales))


def _relocated(scene: GaussianScene, counts: torch.Tensor, dead_opacity: float):
    """(logit opacity (cap, 1), log scale (cap, 3)) of each row split into
    counts + 1 copies (the donor keeps one)."""
    new_op, new_scale = compute_relocation(torch.sigmoid(scene.logit_opacities[:, 0]),
                                           scene.scales, counts + 1)
    new_op = torch.clamp(new_op, dead_opacity, 1.0 - 1e-7)
    return (gmath.inverse_sigmoid(new_op)[:, None],
            torch.log(torch.clamp(new_scale, min=1e-12)))


def _split_to(scene: GaussianScene, donor_idx: torch.Tensor, targets: torch.Tensor,
              has_donors: torch.Tensor, dead_opacity: float) -> torch.Tensor:
    """Copy each target row (bool (cap,)) from its donor, then give the
    donors the relocated opacity and scale. Returns the rows touched."""
    cap = targets.shape[0]
    counts = torch.zeros(cap, dtype=torch.int32, device=targets.device)
    counts.scatter_add_(0, donor_idx, targets.to(torch.int32))
    new_logit_op, new_log_scale = _relocated(scene, counts, dead_opacity)
    write = targets & has_donors
    _copy_rows(scene, donor_idx, write, new_logit_op, new_log_scale)
    # Donors also take the relocated opacity and scale.
    donor_touched = ((counts > 0) & has_donors)[:, None]
    scene.logit_opacities.copy_(torch.where(donor_touched, new_logit_op,
                                            scene.logit_opacities))
    scene.log_scales.copy_(torch.where(donor_touched, new_log_scale, scene.log_scales))
    return write | donor_touched[:, 0]


@torch.no_grad()
def densify_step(scene: GaussianScene, opt_state, seed: int, step: torch.Tensor,
                 cap_max: int, dead_opacity: float = 0.005, growth_factor: float = 1.05,
                 draw: Optional[Callable] = None) -> None:
    """One MCMC densification step, in place on `scene` and `opt_state`:

      1. alive Gaussians with opacity <= dead_opacity are re-seeded at
         donors drawn in proportion to opacity among the other alive ones;
      2. dead capacity slots are revived, in slot order, up to
         min(cap_max, int(f32(growth_factor) * f32(n_alive))) alive, each
         copied from a donor drawn in proportion to opacity.

    The Adam moments of every rewritten row and every donor are zeroed.
    `draw(probs, which) -> (cap,) int64 donor rows` (which 0: relocation,
    1: growth) defaults to `ops.random.categorical` keyed on (seed, step,
    which), `step` the 0-d step tensor on the scene's device (`fit` passes
    the post-update counter, JAX's `fold_in(PRNGKey(rng + 1), step)`)."""
    if draw is None:
        def draw(probs, which):
            return prng.categorical(probs, seed, step, lane=which)

    # --- 1. relocation of near-dead alive Gaussians ---
    alive = scene.alive > 0.5
    op = scene.opacities[:, 0]  # alive-masked activation
    is_dead = alive & (op <= dead_opacity)
    donor_probs = torch.where(alive & ~is_dead, op, torch.zeros_like(op))
    has_donors = torch.sum(donor_probs) > 0
    touched = _split_to(scene, draw(donor_probs, 0), is_dead, has_donors, dead_opacity)

    # --- 2. capped growth into dead capacity slots ---
    n_alive = torch.sum(scene.alive).to(torch.int32)
    n_f = n_alive.to(torch.float32)
    grown = (n_f * torch.full_like(n_f, growth_factor)).to(torch.int32)  # f32, as JAX
    target = torch.clamp(grown, max=cap_max)
    num_new = torch.clamp(target - n_alive, min=0)
    dead = 1.0 - scene.alive
    dead_rank = torch.cumsum(dead, dim=0) * dead  # 1-based, f32 as JAX
    revive = (dead_rank > 0) & (dead_rank <= num_new.to(torch.float32))

    op2 = scene.opacities[:, 0]
    probs2 = torch.where(scene.alive > 0.5, op2, torch.zeros_like(op2))
    has_donors2 = torch.sum(probs2) > 0
    touched = touched | _split_to(scene, draw(probs2, 1), revive, has_donors2,
                                  dead_opacity)
    scene.alive.copy_(torch.where(revive & has_donors2, torch.ones_like(scene.alive),
                                  scene.alive))
    _zero_param_rows(opt_state, touched.to(torch.float32))
