"""Serving nodes (`redtail_tpu/runtime/nodes.py`): the `stereo_dnn_ros`
equivalent, serving subset.

`StereoNode` answers one frame pair per call, synchronously: resize on the
host only when the frame size differs from the model's (`cv2`, imported
then), space-to-depth pack with BGR -> RGB folded in on the host, upload
the uint8 frames to the node's device, normalize there, run the model
(stem in its 3x3 s2d form, cost volumes in the CUDA kernels on the card)
and return the (H, W) float32 disparity in pixels: the 3D models return
pixels already, the correlation model's sigmoid output is multiplied by
the width (`stereo_dnn_ros_node.cpp:77-95`). The 3D models serve their
fused unpacked head, or the packed head when it is selected at the call
(`packed3d_lowering()` around it, or ``REDTAIL_TPU_PACKED3D=1``, the JAX
package's switch; `models/stereo.py`).

Frames in flight (``overlap``/``microbatch``), the uint16 wire, quantized
weights and pinning to another card are later slices and raise
`NotImplementedError` (ROADMAP.md, module queue items 6 and 7).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from redtail_tpu_torch import resolve_device
from redtail_tpu_torch.models.stereo import (
    StereoNet,
    StereoSpec,
    params_from_numpy,
)
from redtail_tpu_torch.ops.space_to_depth import space_to_depth2_np
from redtail_tpu_torch.runtime.profiler import StageProfiler


def _host_resize(x_u8: np.ndarray, hw, *, interpolation: str) -> np.ndarray:
    """Resize frames to the model size on the host, only when they differ
    (INTER_AREA for the stereo apps, as the reference did)."""
    if x_u8.shape[-3:-1] == tuple(hw):
        return x_u8
    import cv2
    interp = {"cubic": cv2.INTER_CUBIC, "area": cv2.INTER_AREA}[interpolation]
    h, w = hw
    if x_u8.ndim == 3:
        return cv2.resize(x_u8, (w, h), interpolation=interp)
    return np.stack([cv2.resize(f, (w, h), interpolation=interp)
                     for f in x_u8])


def _check_single_device(device) -> None:
    if device is None:
        return
    device = torch.device(device)
    if device.type == "cuda" and (device.index or 0) != 0:
        raise NotImplementedError(
            "pinning a stage to another card is not ported yet (ROADMAP.md, "
            "module queue item 10)")


class StereoNode:
    """Stereo disparity stage: ``node(left_bgr_u8, right_bgr_u8) -> disp``.

    ``params``: a `StereoNet` or the JAX package's nested numpy param dict.
    ``device``: ``None`` is the card; ``"cpu"`` runs on the CPU."""

    def __init__(self, spec: StereoSpec, params, *,
                 dtype: torch.dtype = torch.bfloat16,
                 quantize: Optional[str] = None,
                 profiler: Optional[StageProfiler] = None,
                 device=None, overlap: int = 0, microbatch: int = 1,
                 wire: str = "f32"):
        if overlap or microbatch != 1:
            raise NotImplementedError(
                "overlap/microbatch serving is not ported yet (ROADMAP.md, "
                "module queue item 6)")
        if wire != "f32":
            raise NotImplementedError(
                f"wire={wire!r} is not ported yet (ROADMAP.md, module queue "
                "item 6)")
        if quantize is not None:
            raise NotImplementedError(
                f"quantize={quantize!r} is not ported yet (ROADMAP.md, "
                "module queue item 7)")
        _check_single_device(device)
        self._device = resolve_device(device)
        self.spec = spec
        self.profiler = profiler or StageProfiler()
        self._dtype = dtype
        if isinstance(params, StereoNet):
            self.net = params.to(device=self._device, dtype=dtype)
        else:
            self.net = params_from_numpy(spec, params, device=self._device,
                                         dtype=dtype)
        self._hw = tuple(spec.input_hw)

    def _host_prep(self, x_u8: np.ndarray) -> np.ndarray:
        """Resize if needed, then BGR -> RGB and s2d pack, on host uint8."""
        x_u8 = _host_resize(x_u8, self._hw, interpolation="area")
        return space_to_depth2_np(x_u8[..., ::-1])

    def _upload(self, x_u8: np.ndarray) -> torch.Tensor:
        x = torch.from_numpy(np.ascontiguousarray(x_u8)).to(self._device)
        return (x.float() / 255.0).to(self._dtype)

    @torch.inference_mode()
    def __call__(self, left_u8, right_u8) -> np.ndarray:
        left_u8, right_u8 = np.asarray(left_u8), np.asarray(right_u8)
        if left_u8.ndim == 3:
            left_u8, right_u8 = left_u8[None], right_u8[None]
        if len(left_u8) != 1 or len(right_u8) != 1:
            raise ValueError(
                "StereoNode serves one frame pair per call ((H, W, 3) "
                f"or (1, H, W, 3)); got leading dims "
                f"{len(left_u8)}/{len(right_u8)}")
        name = f"stereo/{self.spec.name}"
        with self.profiler.stage(f"{name}/pack"):
            left_p = self._host_prep(left_u8)
            right_p = self._host_prep(right_u8)
        with self.profiler.stage(name):
            disp = self.net(self._upload(left_p), self._upload(right_p))
            if self.spec.corr:  # sigmoid-normalized: x width -> pixels
                disp = disp * self._hw[1]
            return disp.float().cpu().numpy()[0]
