"""The comparison that decides ``correct``.

Set-up drives the program's first ``CHECK_ROUNDS`` rounds through the
window's own call and feed; the reference follows the same rounds from
the same seed. These numbers are read; a cell compares those that its
limits (``portbench/workloads/<cell>.json``) name:

  * ``loss_gap``: the largest |program - reference| / |reference| of a
    round's mean loss;
  * ``step1_gap``: over the parameter leaves, the largest gap between
    the norms of the program's and the reference's change in the first
    round (what the server's update applied: the gradient as the
    optimizer got it), measured against the larger of that leaf's
    reference norm and the median leaf's;
  * ``change_gap``: the same for the change over all the rounds;
  * ``step1_median_gap``, ``change_median_gap``: the median leaf's gap
    of the two, steady where one small leaf's swings from seed to seed
    (an MoE router's, whose gradient follows every routing flip between
    bf16 and f32 hidden states).

A leaf whose first-round change in the reference is under a thousandth
of the median leaf's (a gain that rounding holds still) is left out of
the leaf numbers, by that rule and not by name.
"""
from __future__ import annotations

import math
import statistics

#: rounds the program runs in set-up and the reference follows
CHECK_ROUNDS = 3
#: a leaf counts when its reference change is at least this share of
#: the median leaf's
LEAF_FLOOR = 1e-3
NUMBERS = ("loss_gap", "step1_gap", "change_gap", "step1_median_gap",
           "change_median_gap")


def _leaf_gaps(prog: dict, ref: dict, kept: list) -> dict:
    """{leaf: gap}, NaN read as infinite."""
    floor = statistics.median(ref[k] for k in kept)
    out = {}
    for k in kept:
        gap = abs(prog.get(k, math.nan) - ref[k]) / max(ref[k], floor)
        out[k] = math.inf if math.isnan(gap) else gap
    return out


def _worst(g: dict) -> tuple[float, str]:
    at = max(g, key=g.get)
    return g[at], at


def _median(g: dict) -> tuple[float, str]:
    return statistics.median(g.values()), "the median leaf"


def gaps(prog: dict, ref: dict) -> dict:
    """{number: (value, where)} of program readings against reference
    readings, each {"loss": [...], "step1": {leaf: norm}, "change":
    {leaf: norm}}."""
    loss, at = 0.0, ""
    for r, (p, q) in enumerate(zip(prog["loss"], ref["loss"], strict=True)):
        g = abs(p - q) / abs(q)
        if not g <= loss:
            loss, at = (math.inf if math.isnan(g) else g), f"round {r}"
    med = statistics.median(ref["step1"].values())
    kept = [k for k, v in ref["step1"].items() if v >= LEAF_FLOOR * med]
    step1 = _leaf_gaps(prog["step1"], ref["step1"], kept)
    change = _leaf_gaps(prog["change"], ref["change"], kept)
    return {"loss_gap": (loss, at), "step1_gap": _worst(step1),
            "change_gap": _worst(change),
            "step1_median_gap": _median(step1),
            "change_median_gap": _median(change)}


def verdict(found: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {number: {"value", "limit"}}): correct when every
    number the cell compares (the ones its limits name) is within its
    limit."""
    checks = {n: {"value": found[n][0], "limit": limits[n]}
              for n in NUMBERS if n in limits}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
