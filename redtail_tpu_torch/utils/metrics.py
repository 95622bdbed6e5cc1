"""Disparity accuracy metrics: D1 and EPE (`redtail_tpu/utils/metrics.py`).

The reference headlines KITTI-2015 D1 error for every stereo model
(`stereoDNN/README.md:28-31,35-36`) but ships no evaluation code; these
quantify the serving rungs (fp32 / bf16 / packed / w8 / int8) in the
reference's own terms, against a golden disparity where KITTI's ground
truth is absent.

Definitions (KITTI 2015 development kit):

- EPE: mean |pred - gt| over valid pixels.
- D1: fraction of valid pixels whose error exceeds BOTH 3 px and 5% of
  the ground-truth disparity.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def disparity_errors(pred: np.ndarray, gt: np.ndarray,
                     valid: Optional[np.ndarray] = None,
                     *, d1_px: float = 3.0, d1_frac: float = 0.05
                     ) -> Dict[str, float]:
    """EPE and D1 (and a few supporting stats) between two disparity maps.

    ``valid``: boolean mask (default gt > 0, the KITTI convention for
    sparse ground truth; for a dense reference every pixel counts: pass
    ``valid=np.ones_like(gt, bool)``)."""
    pred = np.asarray(pred, np.float64)
    gt = np.asarray(gt, np.float64)
    if pred.shape != gt.shape:
        raise ValueError(f"shape mismatch {pred.shape} vs {gt.shape}")
    if valid is None:
        valid = gt > 0
    valid = np.asarray(valid, bool)
    n = int(valid.sum())
    if n == 0:
        raise ValueError("no valid pixels")
    err = np.abs(pred - gt)[valid]
    gtv = gt[valid]
    outlier = (err > d1_px) & (err > d1_frac * np.abs(gtv))
    return {
        "epe": float(err.mean()),
        "d1": float(outlier.mean()),
        "err_max": float(err.max()),
        "err_median": float(np.median(err)),
        "n_valid": n,
    }


def d1(pred, gt, valid=None) -> float:
    return disparity_errors(pred, gt, valid)["d1"]


def epe(pred, gt, valid=None) -> float:
    return disparity_errors(pred, gt, valid)["epe"]
