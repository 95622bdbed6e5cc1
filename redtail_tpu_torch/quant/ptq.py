"""Per-channel int8 weight quantization (`redtail_tpu/quant/ptq.py`, the
numpy helpers the TrailNet w8 artifact needs). Calibration, `conv2d_int8`
and the stereo rungs are a later slice (ROADMAP.md, module queue item 7).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def quantize_per_channel(w: np.ndarray, axis: int = -1
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-channel int8: returns (int8 values, fp32 scales)."""
    w = np.asarray(w, np.float32)
    reduce_axes = tuple(i for i in range(w.ndim) if i != axis % w.ndim)
    amax = np.abs(w).max(axis=reduce_axes, keepdims=True)
    scale = np.maximum(amax, 1e-8) / 127.0
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)


def dequantize(q: np.ndarray, scale: np.ndarray) -> np.ndarray:
    return q.astype(np.float32) * scale
