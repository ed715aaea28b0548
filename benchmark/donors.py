"""The check of a densify event: the program's donors, recovered from its
state after the event, handed to the reference's event, and held to the
rule as a draw.

The donors are a sampling decision, compared as a draw and not followed
(as a served model's logits are compared and its sampled tokens are not):
the program and the reference reach the event with opacities that differ
by round-off, and an inverse-CDF draw over 10^5 weights flips a donor now
and then. So:

- recovery: after the event, a revived or relocated row holds its donor's
  mean bit for bit. A target's donor is a row the draw may pick (weight
  above 0 in the reference) whose mean equals the target's. A relocated
  row and its donor are the same row after relocation, so a growth clone
  can match either: the match whose opacity and scale also equal the
  clone's is its donor (a donor takes the split opacity and scale that it
  hands its clones); among matches alike in all of these any one is taken,
  since either gives the same state;
- `donor_gap`: over the draws recovered, the largest distance between the
  draw's keyed uniform times the total weight and its donor's interval of
  the reference's float64 CDF, over the mean donor weight (the least over
  the matches taken as alike). A sound draw reads round-off; a draw made
  under another key lands anywhere;
- a target with no match is drawn by the reference itself at its keyed
  uniform, and the run is not consistent; so is one whose revived rows
  are not the rule's.

`uniform64` is a frozen copy of `nlos_gaussian_renderer_tpu_torch/ops/
random.py:uniform64` (commit 1e0d4ae), keyed as `train.fit` keys its
draws: seed `rng + 1`, the post-update step counter, lanes 2 which and
2 which + 1 (which 0: relocation, 1: growth).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import reference

_MASK32 = 0xFFFFFFFF


def _mul32(x, c: int):
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


def uniform64(seed: int, step: int, rows: int, lane: int, device="cpu") -> torch.Tensor:
    """(rows,) float64 uniforms in [0, 1), 53 bits, of (seed, step, row,
    lanes 2 lane and 2 lane + 1)."""
    key = _mix32(_mix32(int(seed)) ^ 0x9E3779B9)
    s = _mix32((int(step) & _MASK32) ^ key)
    ln = torch.arange(2 * lane, 2 * lane + 2, dtype=torch.int64, device=device)
    s = _mix32(s ^ _mix32(ln + 0x632BE5AB))
    row = _mix32(torch.arange(rows, dtype=torch.int64, device=device) ^ 0x85EBCA6B)
    w = _mix32(row[:, None] ^ s[None, :])
    return ((w[:, 0] >> 11) * 4294967296 + w[:, 1]).to(torch.float64) * 2.0**-53


def _bits(t) -> np.ndarray:
    """(cap, k) int32 bit patterns of a float32 tensor's rows."""
    return t.detach().float().reshape(t.shape[0], -1).cpu().numpy().view(np.int32)


class Recovered:
    """`pick` for `reference.densify_event`: the donors of the program's
    state `prog` (its parameters after the event), and the draws' record.
    `seed` is the program's densify seed, `counter` the event's step
    counter. After the event: `targets`, `recovered` (counts over both
    phases), `gaps` (one a recovered draw)."""

    def __init__(self, prog: dict, seed: int, counter: int):
        self.means = _bits(prog["means"])
        self.form = np.concatenate([_bits(prog["logit_opacities"]), _bits(prog["log_scales"])], 1)
        self.seed, self.counter = seed, counter
        self.targets = self.recovered = 0
        self.gaps = []

    def __call__(self, which: int, weights, targets) -> torch.Tensor:
        cap = weights.shape[0]
        dev = weights.device
        u = uniform64(self.seed, self.counter, cap, which, dev)
        donors = reference.draw(weights, u)  # a row with no match: the rule's own draw
        rows = torch.nonzero(targets)[:, 0].tolist()
        if not rows:
            return donors
        w = weights.double().cpu().numpy()
        cdf = np.cumsum(w)
        total = cdf[-1]
        if total <= 0:
            return donors
        mean_w = total / np.count_nonzero(w > 0)
        x = u.cpu().numpy() * total
        by_mean = {}
        for j in np.nonzero(w > 0)[0].tolist():
            by_mean.setdefault(self.means[j].tobytes(), []).append(j)
        out = donors.cpu().numpy().copy()
        self.targets += len(rows)
        for i in rows:
            match = [j for j in by_mean.get(self.means[i].tobytes(), ()) if j != i]
            if not match:
                continue
            alike = [j for j in match if np.array_equal(self.form[j], self.form[i])] or match
            out[i] = alike[0]
            self.recovered += 1
            self.gaps.append(min(max(cdf[j] - w[j] - x[i], x[i] - cdf[j], 0.0)
                                 for j in alike) / mean_w)
        return torch.as_tensor(out, device=dev)


def event_counter(optim: dict, step0: int, steps: int):
    """The step counter of the densify event after the last of `steps`
    steps from the step counter `step0`, or None. An event after an earlier
    step cannot be checked (the program shows its state at the chunk's end
    alone): that raises."""
    fires = [reference.densify_fires(optim, step0 + i + 1) for i in range(steps)]
    if any(fires[:-1]):
        raise ValueError(f"a densify event inside the checked chunk from step counter {step0}: "
                         "choose the traffic's start_step so that it falls after the last step")
    return step0 + steps if fires[-1] else None


def with_event(ref: dict, optim: dict, counter: int, prog_params, seed: int) -> dict:
    """`ref` (what `reference.follow` returned) after the event at
    `counter`, its donors recovered from the program's parameters
    `prog_params` (None: the reference's own draws at the keyed uniforms,
    the reference put in the program's place). Adds 'donor_gap' and
    'event' {'relocated', 'revived', 'targets', 'recovered', 'revived_as_rule'}."""
    p = {k: v.clone() for k, v in ref["params"].items()}
    mu = {k: v.clone() for k, v in ref["mu"].items()}
    nu = {k: v.clone() for k, v in ref["nu"].items()}
    alive0 = p["alive"] > 0.5
    if prog_params is None:
        def pick(which, weights, targets):
            return reference.draw(weights, uniform64(seed, counter, weights.shape[0], which,
                                                     weights.device))
        rec = None
    else:
        pick = rec = Recovered(prog_params, seed, counter)
    rows = reference.densify_event(p, mu, nu, optim["cap_max"], pick)
    event = dict(relocated=int(rows["relocated"].sum()), revived=int(rows["revived"].sum()))
    gap = None
    if rec is not None:
        revived = (prog_params["alive"] > 0.5) & ~alive0.to(prog_params["alive"].device)
        event.update(targets=rec.targets, recovered=rec.recovered,
                     revived_as_rule=bool(torch.equal(revived.cpu(), rows["revived"].cpu())))
        gap = float(max(rec.gaps)) if rec.gaps else None
    return dict(ref, params=p, mu=mu, nu=nu, donor_gap=gap, event=event)


def consistent(ref: dict) -> bool:
    """Every target's donor recovered and the revived rows the rule's (true
    where no event was checked)."""
    ev = ref.get("event")
    if ev is None or "targets" not in ev:
        return True
    return ev["recovered"] == ev["targets"] and ev["revived_as_rule"]
