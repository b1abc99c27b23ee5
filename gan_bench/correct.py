"""How ``correct`` is decided for a training cell: the program's readings of
its first three steps against the plain reference's (``reference/plain.py``
``readings``), each number that the cell's limits name
(``workloads/<cell>.json``, key ``limits``) against its limit.

- ``loss_gap``: over the three steps and both losses, ``|program -
  reference|`` over the reference's scale of that loss (the mean
  magnitudes of its terms); ``loss1_gap`` the same of the first step.
- ``first_logit_gap``: over every logit the critic gave in its first
  update (each real, fake and penalty sample's), ``|program - reference|``
  over the spread of the reference's (their standard deviation: how far
  the critic tells its samples apart); a program that gives another
  number of them (a sample left out) reads infinity.
- ``grad_gap``: over every parameter, the gap between the norms of its
  first gradient as its optimizer gets it, over the larger of the
  reference's norm of that leaf and of its network's median leaf.
  ``grad_d_gap``: the same over D's parameters; where the reference gives
  alternatives of D's first gradient (a hinge logit within rounding of its
  kink counted on either side, ``reference/plain.py``
  ``kink_alternatives``), the gap to the nearest of them;
  ``grad_d_median_gap`` the median of D's leaves' gaps.
- ``change_gap``: the same of each leaf's change over the three steps
  (parameters, the EMA of G, the spectral-norm ``u`` and batch-norm
  statistics), leaving out the parameters (and their EMA) whose first
  reference gradient is under a thousandth of their network's median
  leaf's: those move under Adam by round-off alone.
  ``change_group_gap``: the median of those gaps in each group of leaves
  (``g``, ``d``, ``ema``, ``gbuf``, ``dbuf``: G's and D's parameters, G's
  EMA, G's and D's buffers), the worst group's; a group left as it was
  reads about 1.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Tuple

ROUNDOFF = 1e-3


def _group(name: str) -> str:
    return name.split(".", 1)[0]


def _scales(ref: Dict[str, float], keep) -> Dict[str, float]:
    """Each kept leaf's scale: the larger of its reference norm and its
    group's median."""
    medians: Dict[str, float] = {}
    for g in {_group(n) for n in ref}:
        vals = [v for n, v in ref.items() if _group(n) == g and keep(n)]
        medians[g] = statistics.median(vals) if vals else 0.0
    return {n: max(r, medians[_group(n)]) for n, r in ref.items() if keep(n)}


def _gap(p: float, r: float, scale: float) -> float:
    return abs(p - r) / scale if scale > 0 else (0.0 if p == r else math.inf)


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keep) -> Dict[str, float]:
    return {n: _gap(prog.get(n, math.nan), ref[n], s) for n, s in _scales(ref, keep).items()}


def roundoff_leaves(ref: dict) -> set:
    """Parameters whose first reference gradient is under ``ROUNDOFF`` of
    their network's median leaf's, by name (``g.x``, ``d.x``)."""
    out = set()
    for g in ("g", "d"):
        vals = {n: v for n, v in ref["grad"].items() if _group(n) == g}
        if vals:
            med = statistics.median(vals.values())
            out |= {n for n, v in vals.items() if v < ROUNDOFF * med}
    return out


def _worst(per: Dict[str, float]) -> Tuple[float, str]:
    if not per:
        return math.inf, "-"
    name = max(per, key=lambda n: (math.isnan(per[n]), per[n]))
    return (math.inf if math.isnan(per[name]) else per[name]), name


def _median(vals: List[float]) -> float:
    return statistics.median(vals) if vals and not any(math.isnan(v) for v in vals) else math.inf


def _grad_d(prog: dict, ref: dict, keep) -> Tuple[float, str]:
    """D's worst leaf of the first gradient against the nearest of the
    reference's alternatives (its own gradient when it gives none); each
    leaf's scale is the reference's own."""
    scales = {n: s for n, s in _scales(ref["grad"], keep).items() if n.startswith("d.")}
    alts = ref.get("grad_alternatives") or [ref["grad"]]
    best = (math.inf, "-")
    for alt in alts:
        per = {n: _gap(prog["grad"].get(n, math.nan), alt[n], s) for n, s in scales.items()}
        best = min(best, _worst(per))
    where = best[1] if len(alts) == 1 else f"{best[1]} (nearest of {len(alts)} alternatives)"
    return best[0], where


def gaps(prog: dict, ref: dict) -> Tuple[Dict[str, float], Dict[str, str]]:
    """Every number, and the leaf (or step and loss, or group) that set each."""
    loss = {}
    for k, (ps, rs) in enumerate(zip(prog["losses"], ref["losses"])):
        for name, (r, scale) in rs.items():
            p = ps.get(name, (math.nan,))[0]
            loss[f"step{k + 1}.{name}"] = abs(p - r) / scale if scale > 0 else math.inf
    if len(prog["losses"]) != len(ref["losses"]):
        loss["steps"] = math.inf
    skip = roundoff_leaves(ref)
    moved = lambda n: not (n in skip or (n.startswith("ema.") and f"g.{n[4:]}" in skip))
    grad = _leaf_gaps(prog["grad"], ref["grad"], moved)
    change = _leaf_gaps(prog["change"], ref["change"], moved)
    p_log, r_log = prog.get("first_logits", []), ref.get("first_logits", [])
    scale = statistics.pstdev(r_log) if r_log else 0.0
    first_logits = ({f"logit{i}": _gap(p, r, scale) for i, (p, r) in enumerate(zip(p_log, r_log))}
                    if len(p_log) == len(r_log) else {"count": math.inf})
    per = {"loss_gap": loss,
           "first_logit_gap": first_logits,
           "loss1_gap": {n: v for n, v in loss.items() if n.startswith("step1.")},
           "grad_gap": grad, "change_gap": change}
    numbers, where = {}, {}
    for key, values in per.items():
        numbers[key], where[key] = _worst(values)
    numbers["grad_d_gap"], where["grad_d_gap"] = _grad_d(prog, ref, moved)
    numbers["grad_d_median_gap"] = _median([v for n, v in grad.items() if n.startswith("d.")])
    where["grad_d_median_gap"] = "median of D's leaves"
    groups = {g: _median([v for n, v in change.items() if _group(n) == g])
              for g in sorted({_group(n) for n in change})}
    numbers["change_group_gap"], worst = _worst(groups) if groups else (math.inf, "-")
    where["change_group_gap"] = (f"group {worst}; medians "
                                 + ", ".join(f"{g} {v:.4g}" for g, v in groups.items()))
    return numbers, where


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, dict]:
    """``(correct, checks)``: checks maps each number the limits name to its
    value and limit; a number is within its limit when it is finite and not
    above it."""
    checks = {k: {"value": numbers[k], "limit": limit} for k, limit in limits.items()}
    ok = bool(checks) and all(c["limit"] is not None and math.isfinite(c["value"])
                              and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
