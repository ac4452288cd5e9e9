"""The numbers that decide ``correct``, each against the reference, and
their limits (``limits/<cell>.json``, with the readings each was set
from).

Training (the first steps of the object the window trains):
- ``loss_gap``: the largest relative gap of a step's loss;
- ``grad_gap``: by the worst leaf, the gap between the norms of the
  program's and the reference's first gradient (the program's from
  AdamW's first moment after one step), over the larger of the
  reference's norm of that leaf and of the median leaf;
- ``change_gap``: the same of the weights' change over the steps, left
  out the leaves whose reference gradient is under a thousandth of the
  median leaf's (they move by rounding alone).

Serving (a sample of the window's answers, drawn from the seed):
- ``score_gap``: the largest gap of a class's log score between the
  served row and the reference's row of the same clip."""

import math

import torch


def _norms(tensors):
    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in tensors.items()}


def norm_gap(prog, ref, keep=None):
    """(max over leaves of |prog - ref| / max(ref, median ref), that
    leaf) of two {leaf: norm} dicts; ``keep`` the leaves to compare."""
    keys = [k for k in ref if keep is None or k in keep]
    if not keys:
        return 0.0, None
    med = sorted(ref[k] for k in keys)[len(keys) // 2]
    worst, leaf = 0.0, None
    for k in keys:
        scale = max(ref[k], med)
        if scale <= 0:
            continue
        gap = abs(prog.get(k, 0.0) - ref[k]) / scale
        if gap >= worst:
            worst, leaf = gap, k
    return worst, leaf


def moving_leaves(ref_grad_norms):
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    vals = sorted(ref_grad_norms.values())
    if not vals:
        return set()
    med = vals[len(vals) // 2]
    return {k for k, v in ref_grad_norms.items() if v >= 1e-3 * med}


def as_program(ref):
    """run_steps' output in the form the program's readings take."""
    return {"loss": list(ref["loss"]), "grad_norm": _norms(ref["grad"]),
            "change_norm": _norms(ref["change"])}


def train_numbers(prog, ref, worst=None):
    """``prog``: {"loss": [..], "grad_norm": {leaf: ..}, "change_norm":
    {leaf: ..}}; ``ref``: run_steps' output. ``worst``, a dict, gets the
    leaf that sets each norm gap."""
    ref_grad = _norms(ref["grad"])
    for k in ref["change"]:
        ref_grad.setdefault(k, 0.0)
    ref_change = _norms(ref["change"])
    loss = math.inf
    if len(prog["loss"]) == len(ref["loss"]) and all(
            math.isfinite(v) for v in prog["loss"]):
        loss = max(abs(a - b) / abs(b)
                   for a, b in zip(prog["loss"], ref["loss"]))
    grad, grad_leaf = norm_gap(prog["grad_norm"], ref_grad)
    change, change_leaf = norm_gap(prog["change_norm"], ref_change,
                                   moving_leaves(ref_grad))
    if worst is not None:
        worst.update(grad_gap=grad_leaf, change_gap=change_leaf)
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change}


def score_gap(served, ref_scores):
    """Largest |log served - log reference| over the rows and classes."""
    s = torch.as_tensor(served, dtype=torch.float64)
    r = torch.as_tensor(ref_scores, dtype=torch.float64)
    if s.shape != r.shape or not bool(torch.isfinite(s).all()):
        return math.inf
    return float((s.clamp_min(1e-30).log() - r.clamp_min(1e-30).log()).abs().max())


def judge(numbers, limits):
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit."""
    shown = {k: {"value": v, "limit": limits[k]["limit"]}
             for k, v in numbers.items() if k in limits}
    ok = all(math.isfinite(v["value"]) and v["value"] <= v["limit"]
             for v in shown.values()) and len(shown) == len(limits)
    return ok, shown
