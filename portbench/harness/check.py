"""The comparison that decides `correct`: what the timed path produced
against the plain reference (`portbench/reference/`), each number beside
its limit (`limits/<cell>.json`, with the readings it was set from).

Serving: a sample of the frames the window completed, drawn from the seed;
each sampled disparity map against the reference's forward of the same
uint8 pair, in pixels.

Training: the program's first three steps (taken in set-up through the
window's own step function, on three distinct batches) against the
reference's three steps from the same weights and batches: each step's
loss, each leaf's first-gradient norm, each leaf's change after the three
steps. Norm gaps are measured against the larger of the reference leaf's
norm and the median leaf's. A leaf whose reference gradient is under a
thousandth of the median leaf's (the final deconv's bias: the soft-argmin
does not see a constant) moves under Adam by round-off alone and is left
out of the change.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Tuple

import numpy as np

NOUGHT_GRAD = 1e-3


def serve_numbers(pairs: List[Tuple[np.ndarray, np.ndarray]]
                  ) -> Dict[str, float]:
    """(served, reference) disparity maps -> the worst frame's mean gap,
    the widest pixel gap, the worst frame's share of pixels off by more
    than 1 px."""
    if not pairs:  # nothing completed, nothing to vouch for
        return {"mean_abs_px": float("inf"), "max_abs_px": float("inf"),
                "share_over_1px": 1.0}
    mean_gap = max_gap = off = 0.0
    for got, want in pairs:
        if got.shape != want.shape or not np.isfinite(got).all():
            return {"mean_abs_px": float("inf"), "max_abs_px": float("inf"),
                    "share_over_1px": 1.0}
        gap = np.abs(got.astype(np.float64) - want.astype(np.float64))
        mean_gap = max(mean_gap, float(gap.mean()))
        max_gap = max(max_gap, float(gap.max()))
        off = max(off, float((gap > 1.0).mean()))
    return {"mean_abs_px": mean_gap, "max_abs_px": max_gap,
            "share_over_1px": off}


def _leaf_gaps(got: Dict[str, float], want: Dict[str, float], keys
               ) -> Dict[str, float]:
    floor = statistics.median(want[k] for k in keys)
    return {k: abs(got[k] - want[k]) / max(want[k], floor) for k in keys}


def _train_gaps(prog: dict, ref: dict) -> Dict[str, Dict[str, float]]:
    """Each leaf's gap of the first gradient's norm, and of the change's
    over the leaves that moved."""
    grads = ref["grad_norms"]
    keys = sorted(grads)
    median = statistics.median(grads[k] for k in keys)
    moved = [k for k in keys if grads[k] >= NOUGHT_GRAD * median]
    return {"grad_gap": _leaf_gaps(prog["grad_norms"], grads, keys),
            "change_gap": _leaf_gaps(prog["change_norms"],
                                     ref["change_norms"], moved)}


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """Each side: {"losses": [...], "grad_norms": {leaf: norm},
    "change_norms": {leaf: norm}}. The worst step's loss gap, and the
    worst leaf's and the median leaf's gap of the first gradient and of
    the change."""
    loss_gap = max(abs(a - b) / abs(b)
                   for a, b in zip(prog["losses"], ref["losses"]))
    if not all(np.isfinite(prog["losses"])):
        loss_gap = float("inf")
    out = {"loss_gap": loss_gap}
    for name, gaps in _train_gaps(prog, ref).items():
        out[name] = max(gaps.values())
        out[f"{name}_median"] = statistics.median(gaps.values())
    return out


def worst_leaves(prog: dict, ref: dict) -> Dict[str, str]:
    """The leaf that sets each worst-leaf gap."""
    return {name: max(gaps, key=gaps.get)
            for name, gaps in _train_gaps(prog, ref).items()}


def judge(numbers: Dict[str, float], limits: dict
          ) -> Tuple[bool, Dict[str, dict]]:
    """Every number with a limit must lie at or under it (a NaN fails)."""
    checks = {}
    ok = True
    for name, entry in limits["numbers"].items():
        value = numbers.get(name, float("inf"))
        passed = bool(value <= entry["limit"])
        ok = ok and passed
        checks[name] = {"value": value, "limit": entry["limit"]}
    return ok, checks
