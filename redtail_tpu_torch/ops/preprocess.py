"""Host preprocessing of camera frames (`redtail_tpu/ops/preprocess.py`).

The stereo apps' path (`stereoDNN/sample_app/main.cpp:83-98`): INTER_AREA
resize, BGR -> RGB, /255. `cv2` is imported only when this runs.
"""

from __future__ import annotations

import numpy as np


def preprocess_stereo_host(img_bgr: np.ndarray, w: int, h: int) -> np.ndarray:
    """(H0, W0, 3) BGR uint8 -> (h, w, 3) RGB float32 in [0, 1]."""
    import cv2

    out = cv2.resize(img_bgr, (w, h), interpolation=cv2.INTER_AREA)
    out = cv2.cvtColor(out, cv2.COLOR_BGR2RGB)
    return out.astype(np.float32) / 255.0
