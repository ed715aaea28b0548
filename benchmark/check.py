"""What decides `correct`: the program's first chunk of `fit` against the
reference following the same steps from the same inputs.

`fit` shows its state only at chunk boundaries, so the reference follows
the whole first chunk (CHUNK steps, from the run's own input state, on the
scan points and targets of the run's own scan order) and the numbers
compared are taken there:

- `loss_gap`: the gap of the chunk's last step's loss, over the
  reference's;
- `hist_gap`: the relative L2 distance of that step's rendered histogram;
- `change_gap`: by the worst leaf (parameter group), the gap between the
  norms of the program's and the reference's change of the leaf over the
  chunk, over the larger of the reference's norm of that leaf's change and
  the median leaf's;
- `moment_gap`: the same for the norms of Adam's first moment after the
  chunk, the optimizer's record of the chunk's gradients;
- `donor_gap`: where a densify event follows the chunk's last step, how
  far the program's donor draws lie from the rule's (`benchmark/donors.py`,
  which also hands the reference's event the program's donors).

A leaf whose gradient at the first step is under a thousandth of the
median leaf's in the reference is left out of both leaf numbers (its
change is round-off); no leaf of these cells is, at their sizes.
"""

from __future__ import annotations

import statistics

import torch

from benchmark import reference

NUMBERS = ("loss_gap", "hist_gap", "change_gap", "moment_gap", "donor_gap")


def _norm(t) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def _leaf_gap(prog: dict, ref: dict, leaves) -> float:
    a = {k: _norm(prog[k]) for k in leaves}
    b = {k: _norm(ref[k]) for k in leaves}
    med = statistics.median(b.values())
    return max(abs(a[k] - b[k]) / max(b[k], med, 1e-300) for k in leaves)


def numbers(p0: dict, prog: dict, prog_last: tuple, ref: dict) -> dict:
    """The compared numbers. `p0` the input parameters; `prog` the
    program's state dict after the chunk ({'params', 'mu', 'nu', 'count'});
    `prog_last` (loss, pred_hist, target_hist) of its last step; `ref` what
    `reference.follow` returned."""
    g1 = {k: _norm(v) for k, v in ref["first_grads"].items()}
    med = statistics.median(g1.values())
    leaves = [k for k in reference.GROUPS if g1[k] >= 1e-3 * med]
    loss_p, hist_p, _ = prog_last
    loss_r = ref["losses"][-1]
    dp_prog = {k: prog["params"][k].double() - p0[k].double() for k in leaves}
    dp_ref = {k: ref["params"][k].double() - p0[k].double() for k in leaves}
    hist_p = hist_p.reshape(-1).double()
    hist_r = ref["hist"].reshape(-1).double()
    return dict(
        loss_gap=abs(float(loss_p) - float(loss_r)) / max(abs(float(loss_r)), 1e-300),
        hist_gap=_norm(hist_p - hist_r) / max(_norm(hist_r), 1e-300),
        change_gap=_leaf_gap(dp_prog, dp_ref, leaves),
        moment_gap=_leaf_gap({k: prog["mu"][k] for k in leaves},
                             {k: ref["mu"][k] for k in leaves}, leaves),
        donor_gap=ref.get("donor_gap"),
    )


def judge(values: dict, limits: dict, consistent: bool = True) -> tuple:
    """(correct, {name: {'value', 'limit'}}): every number the cell gives a
    limit at or under it, and the run's own inputs consistent (the program
    saw the targets and counted the steps the reference followed). A number
    without a limit in the cell's file is not compared: it has no upper
    reading there (no control or fault reads far above its sound runs)."""
    shown = {k: {"value": values.get(k), "limit": limits[k]} for k in NUMBERS if k in limits}
    ok = consistent and all(v["value"] is not None and v["value"] <= v["limit"]
                            for v in shown.values())
    return ok, shown
