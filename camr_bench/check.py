"""What decides ``correct``: the numbers compared between the program's
first steps and the plain reference's, each against its limit.

* ``loss_gap``: the largest relative gap of a job's mean loss at any of
  the recorded steps; ``first_loss_gap`` the same at the first step
  alone, before the two sides' parameters differ (a cell whose later
  steps are noisy compares it instead);
* ``grad_gap``: the worst leaf's gap between the norms of the first
  gradient as AdamW takes it (the program's worked out from its first
  moment after one step), against the reference's norm of that leaf or
  of the job's median leaf, whichever is larger;
* ``delta_gap``: the same of the norms of each leaf's change over the
  recorded steps;
* ``grad_median_gap``, ``delta_median_gap``: the median leaf's gap in
  place of the worst one's (a cell whose small leaves are noisy compares
  them instead).

Leaves whose first reference gradient is under a thousandth of the
job's median leaf's move by round-off alone and are left out of both
leaf gaps.
"""

from __future__ import annotations

import math

import torch

from .reference.common import TrainRecord

__all__ = ["NUMBERS", "STEPS", "gaps", "judge", "worst", "SETTLED"]

#: the steps the check follows: the change after three AdamW steps is
#: what ``delta_gap`` reads
STEPS = 3
#: the numbers a cell may compare (those its ``limits`` name), in order
NUMBERS = ("loss_gap", "first_loss_gap", "grad_gap", "delta_gap",
           "grad_median_gap", "delta_median_gap")
#: a leaf moves by more than round-off when its first gradient's norm is
#: at least this share of the median leaf's
SETTLED = 1e-3


def _leaf_gaps(prog: torch.Tensor, ref: torch.Tensor,
               keep: torch.Tensor) -> tuple:
    """The worst kept leaf's gap, and the largest over the jobs of the
    median kept leaf's."""
    floor = torch.maximum(ref, ref.median(dim=1, keepdim=True).values)
    gap = (prog - ref).abs() / floor
    median = max(float(g[k].median()) for g, k in zip(gap, keep))
    return float(torch.where(keep, gap, 0.0).max()), median


def gaps(prog: TrainRecord, ref: TrainRecord) -> dict:
    """The numbers of :data:`NUMBERS` of the program's record against the
    reference's."""
    rel = [[abs(p - r) / abs(r) for p, r in zip(ps, rs)]
           for ps, rs in zip(prog.losses, ref.losses)]
    g_ref = ref.grad_norms
    keep = g_ref >= SETTLED * g_ref.median(dim=1, keepdim=True).values
    grad, grad_median = _leaf_gaps(prog.grad_norms, g_ref, keep)
    delta, delta_median = _leaf_gaps(prog.delta_norms, ref.delta_norms,
                                     keep)
    return {"loss_gap": float(max(max(r) for r in rel)),
            "first_loss_gap": float(max(rel[0])),
            "grad_gap": grad, "delta_gap": delta,
            "grad_median_gap": grad_median,
            "delta_median_gap": delta_median}


def worst(prog: TrainRecord, ref: TrainRecord, names: list) -> dict:
    """Where each leaf gap is read: the job, the leaf (by ``names``) and
    both norms there, with the job's median reference norm."""
    g_ref = ref.grad_norms
    keep = g_ref >= SETTLED * g_ref.median(dim=1, keepdim=True).values
    out = {}
    for key, p, r in (("grad", prog.grad_norms, g_ref),
                      ("delta", prog.delta_norms, ref.delta_norms)):
        med = r.median(dim=1, keepdim=True).values
        gap = torch.where(keep, (p - r).abs() / torch.maximum(r, med), 0.0)
        j, i = divmod(int(gap.argmax()), gap.shape[1])
        out[key] = {"job": j, "leaf": names[i], "program": float(p[j, i]),
                    "reference": float(r[j, i]),
                    "median_reference": float(med[j, 0])}
    return out


def judge(values: dict, limits: dict) -> tuple:
    """``(correct, checks)``: every number that ``limits`` names finite
    and within its limit; ``checks`` maps each of them to its value and
    limit."""
    checks = {name: {"value": values[name], "limit": limits[name]}
              for name in NUMBERS if name in limits}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
