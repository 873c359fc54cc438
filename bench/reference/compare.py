"""The numbers that decide a training cell's `correct`: the program's
readings against the reference's, per step and per leaf.

Norms are compared, not their difference: a leaf's gap is |norm_program -
norm_reference| over the larger of the reference's norm of that leaf and
of the median leaf, since some gradients are all but zero. The change of a
leaf whose reference gradient is under a thousandth of the median leaf's
moves under Adam by rounding alone, and is left out of the change's gap.
"""
from __future__ import annotations

import statistics
from typing import Dict, List

QUIET = 1e-3


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             skip=frozenset()) -> float:
    keys = [k for k in ref if k not in skip]
    med = statistics.median(ref[k] for k in keys)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
               for k in keys)


def quiet_leaves(grad_ref: Dict[str, float]) -> frozenset:
    med = statistics.median(grad_ref.values())
    return frozenset(k for k, v in grad_ref.items() if v < QUIET * med)


def train_gaps(prog: dict, ref: dict) -> Dict[str, float]:
    """prog / ref: {"loss": [per step], "grad_norm": {leaf: norm of the
    first clipped gradient}, "change": {leaf: norm of the params' change
    over the steps}}."""
    losses: List[float] = [abs(a - b) for a, b in zip(prog["loss"],
                                                      ref["loss"])]
    return {"loss_gap": max(losses),
            "grad_gap": leaf_gap(prog["grad_norm"], ref["grad_norm"]),
            "change_gap": leaf_gap(prog["change"], ref["change"],
                                   quiet_leaves(ref["grad_norm"]))}
