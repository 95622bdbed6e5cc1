"""Preprocessing of camera frames (`redtail_tpu/ops/preprocess.py`): the
host paths (`cv2`, imported only when a function runs) and the on-device
`fused_ingest`.

- The stereo apps' path (`stereoDNN/sample_app/main.cpp:83-98`):
  INTER_AREA resize, BGR -> RGB, /255.
- The `caffe_ros` path (`tensor_net.cpp:303-336`): encoding conversion,
  float32, INTER_CUBIC anisotropic resize, scale, shift (TrailNet feeds raw
  0-255; the graph's sub_mean layer normalizes).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from redtail_tpu_torch import resolve_device


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


def fused_ingest(frame_u8, out_hw: Tuple[int, int], *,
                 bgr_to_rgb: bool = True, scale: float = 1.0 / 255.0,
                 shift: float = 0.0, device=None) -> torch.Tensor:
    """On-device ingest: uint8 (N, H, W, 3) or (H, W, 3) -> float32
    (N, h, w, 3): bilinear resize, channel swap, x * scale + shift; only
    the uint8 frame crosses to the device.

    ``frame_u8``: a tensor, served on its own device, or an array, uploaded
    to ``device`` (``None`` is the card). The resize is
    `F.interpolate(..., "bilinear", antialias=True)`, PyTorch's nearest
    call to `jax.image.resize(..., "bilinear")`: both take half-pixel
    centres, clamp at the edges and widen the triangle kernel when they
    downsample; they differ in the last float32 bits of the weights
    (`tests/test_torch_apps.py` measures it)."""
    x = frame_u8 if isinstance(frame_u8, torch.Tensor) else \
        torch.from_numpy(np.ascontiguousarray(frame_u8)).to(
            resolve_device(device))
    if x.dim() == 3:
        x = x[None]
    x = x.float()
    h, w = out_hw
    if tuple(x.shape[1:3]) != (h, w):
        x = F.interpolate(x.permute(0, 3, 1, 2), size=(h, w),
                          mode="bilinear", align_corners=False,
                          antialias=True).permute(0, 2, 3, 1)
    if bgr_to_rgb:
        x = x.flip(-1)
    return x * scale + shift
