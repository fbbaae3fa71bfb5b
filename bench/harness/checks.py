"""The numbers that decide ``correct``, each beside its limit.

Training (the first check steps of the timed step function against the
reference's from the same weights and batches; the reference keeps the
configuration's state, an f32 master and a working copy rounded from it):

* ``loss_gap``: the first step's |program - reference| / reference loss,
  and ``later_loss_gap``, the largest of the later steps';
* ``grad_gap``: the first gradient as the optimizer got it (its first
  moment after one step over 1 - b1), by the worst leaf: |program norm -
  reference norm| over the larger of the reference's norm of that leaf and
  of the median leaf;
* ``change_gap``: the same for each leaf's change over the check steps of
  the f32 master, and ``work_change_gap`` of the working copy (the bf16
  params the next step computes with).  Leaves whose reference gradient is
  under a thousandth of the median leaf's are left out of both (they move
  by weight decay and round-off alone).

Serving (a sample of the requests served in the window, with the
reference run once over each prompt and its served tokens):

* ``served_gap``: the widest gap by which a served token's reference logit
  lies below the reference's best at that position.
"""
from __future__ import annotations

import math

import numpy as np

SMALL_GRAD = 1e-3


def _rel_by_leaf(prog, ref, keep=None):
    prog, ref = np.asarray(prog, float), np.asarray(ref, float)
    keep = np.ones(len(ref), bool) if keep is None else keep
    med = float(np.median(ref[keep]))
    gaps = np.abs(prog - ref) / np.maximum(ref, med)
    gaps[~keep] = 0.0
    i = int(np.argmax(gaps))
    return float(gaps[i]), i


def training(prog: dict, ref: dict, names: list) -> dict:
    """``{number: value}`` and, under ``"worst"``, the leaves that set the
    gradient's and the change's gaps."""
    gaps = [abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                 ref["losses"])]
    grad_gap, gi = _rel_by_leaf(prog["grad_norms"], ref["grad_norms"])
    rg = np.asarray(ref["grad_norms"], float)
    keep = rg >= SMALL_GRAD * np.median(rg)
    change_gap, ci = _rel_by_leaf(prog["change_norms"], ref["change_norms"],
                                  keep)
    work_gap, wi = _rel_by_leaf(prog["work_change_norms"],
                                ref["work_change_norms"], keep)
    return {"loss_gap": gaps[0], "later_loss_gap": max(gaps[1:], default=0.0),
            "grad_gap": grad_gap, "change_gap": change_gap,
            "work_change_gap": work_gap,
            "worst": {"grad": names[gi], "change": names[ci],
                      "work_change": names[wi],
                      "left_out": [names[i] for i in np.flatnonzero(~keep)]}}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, ``{name: {"value", "limit"}}``): every limited number is
    finite and at most its limit."""
    out, ok = {}, True
    for name, limit in limits.items():
        v = numbers.get(name)
        good = v is not None and math.isfinite(v) and v <= limit
        ok = ok and good
        out[name] = {"value": v, "limit": limit}
    return ok, out
