"""Serving nodes (`redtail_tpu/runtime/nodes.py`): the `stereo_dnn_ros` and
`caffe_ros` equivalents, serving subset. Each answers one frame per call,
synchronously.

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

`TrailNetNode` (BGR uint8 frame -> 6 probabilities) and `YoloNode` (BGR
uint8 frame -> (n, 6) detections [label, prob, x, y, w, h]) resize on the
host with INTER_CUBIC only when the frame's size differs from the net's,
upload the uint8 frame, cast it on the device to the net's dtype and run
the net (a `CaffeNet`, or for TrailNet also the native `TrailNet`); YOLO's
decode and suppression run on the host with the frame's original size.

Frames in flight (``overlap``/``microbatch``), the uint16 wire, quantized
weights and pinning to another card are later slices and raise
`NotImplementedError` (ROADMAP.md, module queue items 6, 7 and 10).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from redtail_tpu_torch import resolve_device
from redtail_tpu_torch.models import yolo
from redtail_tpu_torch.models.stereo import (
    StereoNet,
    StereoSpec,
    params_from_numpy,
)
from redtail_tpu_torch.models.trailnet import INPUT_HW, load_trailnet
from redtail_tpu_torch.ops.space_to_depth import space_to_depth2_np
from redtail_tpu_torch.runtime.profiler import StageProfiler


def _host_resize(x_u8: np.ndarray, hw, *, interpolation: str) -> np.ndarray:
    """Resize frames to the model size on the host, only when they differ
    (INTER_AREA for the stereo apps, INTER_CUBIC for the Caffe models, as
    the reference did)."""
    if x_u8.shape[-3:-1] == tuple(hw):
        return x_u8
    import cv2
    interp = {"cubic": cv2.INTER_CUBIC, "area": cv2.INTER_AREA}[interpolation]
    h, w = hw
    if x_u8.ndim == 3:
        return cv2.resize(x_u8, (w, h), interpolation=interp)
    return np.stack([cv2.resize(f, (w, h), interpolation=interp)
                     for f in x_u8])


def _check_synchronous(overlap: int, microbatch: int = 1) -> None:
    if overlap or microbatch != 1:
        raise NotImplementedError(
            "overlap/microbatch serving is not ported yet (ROADMAP.md, "
            "module queue item 6)")


def _upload_frame(x_u8: np.ndarray, device: torch.device,
                  dtype: torch.dtype) -> torch.Tensor:
    """One (H, W, 3) or (1, H, W, 3) uint8 frame -> (1, H, W, 3) in
    ``dtype`` on ``device``: the bytes cross, the cast runs there."""
    x = torch.from_numpy(np.ascontiguousarray(x_u8)).to(device)
    return (x if x.dim() == 4 else x[None]).to(dtype)


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
        _check_synchronous(overlap, microbatch)
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


class TrailNetNode:
    """TrailNet stage: ``node(frame_bgr_u8) -> (6,)`` float32 probabilities
    (the orientation softmax, then the lateral-offset softmax).

    ``net``: a `CaffeNet` over a TrailNet prototxt or a native `TrailNet`,
    served in its own dtype; ``None`` loads `load_trailnet()`'s default
    prototxt, the reference's, which this repository does not hold (as in
    the JAX package). ``device``: ``None`` is the card; ``"cpu"`` runs on
    the CPU. ``stamp`` is taken for the JAX node's signature; a synchronous
    node answers the frame it is given."""

    def __init__(self, net=None, *, profiler: Optional[StageProfiler] = None,
                 device=None, overlap: int = 0, microbatch: int = 1):
        _check_synchronous(overlap, microbatch)
        _check_single_device(device)
        self._device = resolve_device(device)
        if net is None:
            net = load_trailnet(device=self._device)
        self.net = net.to(self._device)
        self.profiler = profiler or StageProfiler()
        self._hw = INPUT_HW

    @torch.inference_mode()
    def __call__(self, frame_u8, stamp: Optional[float] = None) -> np.ndarray:
        frame_u8 = np.asarray(frame_u8)
        if frame_u8.ndim == 4 and frame_u8.shape[0] != 1:
            raise ValueError(
                "TrailNetNode serves one frame per call ((H, W, 3) or "
                f"(1, H, W, 3)); got a batch of {frame_u8.shape[0]}")
        with self.profiler.stage("trailnet/pack"):
            frame_u8 = _host_resize(frame_u8, self._hw,
                                    interpolation="cubic")
        with self.profiler.stage("trailnet"):
            x = _upload_frame(frame_u8, self._device, self.net.dtype)
            return self.net(x).float().cpu().numpy()[0]


class YoloNode:
    """YOLO stage: ``node(frame_bgr_u8) -> (n, 6)`` float32 detections
    [label, prob, x, y, w, h] in the frame's own pixels (`caffe_ros.cpp:
    155-189`).

    ``net``: a `CaffeNet` taking 448x448 frames to the (1470,) YOLOv1 head.
    ``device``: ``None`` is the card; ``"cpu"`` runs on the CPU."""

    INPUT_HW = (448, 448)

    def __init__(self, net, *, prob_threshold: float = 0.15,
                 iou_threshold: float = 0.2,
                 profiler: Optional[StageProfiler] = None,
                 device=None, overlap: int = 0):
        _check_synchronous(overlap)
        _check_single_device(device)
        self._device = resolve_device(device)
        self.net = net.to(self._device)
        self.prob_threshold = prob_threshold
        self.iou_threshold = iou_threshold
        self.profiler = profiler or StageProfiler()

    @torch.inference_mode()
    def __call__(self, frame_u8, stamp: Optional[float] = None) -> np.ndarray:
        frame_u8 = np.asarray(frame_u8)
        if frame_u8.ndim == 4 and frame_u8.shape[0] != 1:
            raise ValueError(
                "YoloNode serves one frame per call; got a batch of "
                f"{frame_u8.shape[0]}")
        h, w = frame_u8.shape[-3:-1]
        frame_u8 = _host_resize(frame_u8, self.INPUT_HW,
                                interpolation="cubic")
        x = _upload_frame(frame_u8, self._device, self.net.dtype)
        with self.profiler.stage("yolo/dnn"):
            raw = self.net(x).float().cpu().numpy()[0]
        with self.profiler.stage("yolo/postproc"):
            return yolo.postprocess(raw, w, h,
                                    prob_threshold=self.prob_threshold,
                                    iou_threshold=self.iou_threshold)
