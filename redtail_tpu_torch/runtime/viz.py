"""Disparity visualization: KITTI colormap + 2x2 mosaic.

Vectorized port of the reference's `dispToColor` / mosaic rendering
(`ros/packages/stereo_dnn_ros_viz/src/stereo_dnn_ros_viz_node.cpp:49-79`,
which itself credits the KITTI SDK's color scheme). Same weights/cumsum
tables; numpy instead of a per-pixel loop.
"""

from __future__ import annotations

import numpy as np

_WEIGHTS = np.array([8.77192974, 5.40540552, 8.77192974, 5.74712658,
                     8.77192974, 5.40540552, 8.77192974, 0.0], np.float32)
_CUMSUM = np.array([0.0, 0.114, 0.299, 0.413, 0.587, 0.70100003,
                    0.88600004, 1.0], np.float32)
_WMAP = np.array([[0, 0, 0], [0, 0, 1], [1, 0, 0], [1, 0, 1],
                  [0, 1, 0], [0, 1, 1], [1, 1, 0], [1, 1, 1]], np.float32)


def disp_to_color(disp: np.ndarray, max_disp: float = 96.0) -> np.ndarray:
    """(H, W) float disparity -> (H, W, 3) uint8 RGB, KITTI scheme."""
    d = np.asarray(disp, np.float32) / max_disp
    # index = last bin whose cumsum < d (reference loop semantics)
    idx = np.clip(np.searchsorted(_CUMSUM, d, side="left") - 1, 0,
                  len(_CUMSUM) - 2)
    w = 1.0 - (d - _CUMSUM[idx]) * _WEIGHTS[idx]
    w = w[..., None]
    rgb = w * _WMAP[idx] + (1.0 - w) * _WMAP[idx + 1]
    return (rgb * 255.0).astype(np.uint8)


def make_mosaic(left_rgb: np.ndarray, right_rgb: np.ndarray,
                disp: np.ndarray, max_disp: float = 96.0) -> np.ndarray:
    """2x2 mosaic: [left | right ; gray disparity | colored disparity] —
    the `stereo_dnn_ros_viz` output image."""
    h, w = disp.shape
    gray_val = np.clip(disp / max_disp * 255.0, 0, 255).astype(np.uint8)
    gray = np.repeat(gray_val[..., None], 3, axis=-1)
    color = disp_to_color(disp, max_disp)
    top = np.concatenate([left_rgb[:h, :w], right_rgb[:h, :w]], axis=1)
    bottom = np.concatenate([gray, color], axis=1)
    return np.concatenate([top, bottom], axis=0)
