"""Host preprocessing of camera frames (`redtail_tpu/ops/preprocess.py`).
`cv2` is imported only when a function runs.

- The stereo apps' path (`stereoDNN/sample_app/main.cpp:83-98`):
  INTER_AREA resize, BGR -> RGB, /255.
- The `caffe_ros` path (`tensor_net.cpp:303-336`): encoding conversion,
  float32, INTER_CUBIC anisotropic resize, scale, shift (TrailNet feeds raw
  0-255; the graph's sub_mean layer normalizes).
"""

from __future__ import annotations

import numpy as np


def preprocess_stereo_host(img_bgr: np.ndarray, w: int, h: int) -> np.ndarray:
    """(H0, W0, 3) BGR uint8 -> (h, w, 3) RGB float32 in [0, 1]."""
    import cv2

    out = cv2.resize(img_bgr, (w, h), interpolation=cv2.INTER_AREA)
    out = cv2.cvtColor(out, cv2.COLOR_BGR2RGB)
    return out.astype(np.float32) / 255.0


def preprocess_caffe_host(img: np.ndarray, w: int, h: int, *,
                          encoding: str = "bgr8", inp_fmt: str = "BGR",
                          scale: float = 1.0, shift: float = 0.0
                          ) -> np.ndarray:
    """The `caffe_ros::preprocessImage` path: (H0, W0, C) frame ->
    (h, w, 3) float32 in ``inp_fmt`` channel order."""
    import cv2

    conv = {
        ("BGR", "rgb8"): cv2.COLOR_RGB2BGR,
        ("BGR", "bgra8"): cv2.COLOR_BGRA2BGR,
        ("RGB", "bgr8"): cv2.COLOR_BGR2RGB,
        ("RGB", "bgra8"): cv2.COLOR_BGRA2RGB,
    }.get((inp_fmt, encoding))
    if conv is not None:
        img = cv2.cvtColor(img, conv)
    img = img.astype(np.float32)
    img = cv2.resize(img, (w, h), interpolation=cv2.INTER_CUBIC)
    if scale != 1.0:
        img = img * scale
    if shift != 0.0:
        img = img + shift
    return img
