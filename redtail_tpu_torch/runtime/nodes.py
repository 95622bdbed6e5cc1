"""Serving nodes (`redtail_tpu/runtime/nodes.py`): the `stereo_dnn_ros` and
`caffe_ros` equivalents, each a callable for `graph.NodeGraph.add_node`.

`StereoNode` answers one frame pair per call: resize on the host only when
the frame size differs from the model's (`cv2`, imported then),
space-to-depth pack with BGR -> RGB folded in on the host (the native
runtime's single pass, `native.pack_s2d`; raw frames instead under
``REDTAIL_TPU_S2D=0``, `ops.space_to_depth.use_s2d_stem`), upload the uint8
frames to the node's device, normalize there, run the model (stem in its
3x3 s2d form, cost volumes in the CUDA kernels on the card; the towers in
the form the switches of `models/stereo.py` select at the call) and
return the (H, W)
float32 disparity in pixels: the 3D models return pixels already, the
correlation model's sigmoid output is multiplied by the width
(`stereo_dnn_ros_node.cpp:77-95`). The 3D models serve their fused
unpacked head, or the packed head when it is selected at the call
(`packed3d_lowering()` around it, or ``REDTAIL_TPU_PACKED3D=1``, the JAX
package's switch; `models/stereo.py`).

`TrailNetNode` (BGR uint8 frame -> 6 probabilities) and `YoloNode` (BGR
uint8 frame -> (n, 6) detections [label, prob, x, y, w, h]) resize on the
host with INTER_CUBIC only when the frame's size differs from the net's
(`cv2`, imported then, as in the JAX nodes), upload the uint8 frame,
cast it on the device to the net's dtype and run the net (a
`CaffeNet`, or for TrailNet also the native `TrailNet`); YOLO's decode
and suppression run on the host with the frame's original size.

Frames in flight (``overlap``/``microbatch``, `_OverlapMixin`) run on one
CUDA stream per node: uploads from pinned staging buffers, the result
copied to a pinned host buffer, and an event that the host waits on only
when the result is due; the result is then copied out of the buffer. On the CPU the same code runs eagerly and
the queue only shifts the results.

Stage per device: ``device="cuda:k"`` pins a node to card k, as the JAX
nodes pin a stage's params to a device (`_pin_params`): its weights, its
stream, its pinned ring's events and its uploads live there, and every
allocation and launch of the node runs with card k current (the caller's
current card is restored after). A card that is not there raises
`RuntimeError`.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from redtail_tpu_torch import native, on_device, resolve_device
from redtail_tpu_torch.models import yolo
from redtail_tpu_torch.models.stereo import (
    StereoNet,
    StereoSpec,
    params_from_numpy,
)
from redtail_tpu_torch.models.trailnet import INPUT_HW, load_trailnet
from redtail_tpu_torch.ops.space_to_depth import use_s2d_stem
from redtail_tpu_torch.quant import (calibrate_stereo, dequantize_tree,
                                     quantize_stereo_params_int8,
                                     quantize_stereo_params_w8)
from redtail_tpu_torch.runtime.graph import Stamped
from redtail_tpu_torch.runtime.profiler import StageProfiler


def _host_resize(x_u8: np.ndarray, hw, *, interpolation: str) -> np.ndarray:
    """Resize frames to the model size on the host, only when they differ
    (INTER_AREA for the stereo apps, INTER_CUBIC for the Caffe models, as
    the reference did), so the model sees one shape whatever the camera."""
    if x_u8.shape[-3:-1] == tuple(hw):
        return x_u8
    import cv2
    interp = {"cubic": cv2.INTER_CUBIC, "area": cv2.INTER_AREA}[interpolation]
    h, w = hw
    if x_u8.ndim == 3:
        return cv2.resize(x_u8, (w, h), interpolation=interp)
    return np.stack([cv2.resize(f, (w, h), interpolation=interp)
                     for f in x_u8])


def _calib_frame(x_u8, hw) -> np.ndarray:
    """A calibration frame as the JAX node prepares it: float32, resized
    bilinearly (with antialiasing, as `jax.image.resize`) only when its size
    differs, BGR -> RGB, / 255."""
    x = np.asarray(x_u8, np.float32)
    if x.shape[:2] != tuple(hw):
        x = F.interpolate(torch.from_numpy(x).permute(2, 0, 1)[None],
                          size=tuple(hw), mode="bilinear",
                          align_corners=False, antialias=True)[0] \
            .permute(1, 2, 0).numpy()
    return x[..., ::-1] / np.float32(255.0)


def _stage_device(device) -> torch.device:
    """The node's device (`resolve_device`), with its card's index made
    explicit; a card that is not there raises."""
    device = resolve_device(device)
    if device.type != "cuda":
        return device
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    if index >= torch.cuda.device_count():
        raise RuntimeError(f"{device}: only {torch.cuda.device_count()} "
                           "card(s) visible")
    return torch.device("cuda", index)


def _one_frame(x: np.ndarray, what: str) -> np.ndarray:
    """(H, W, C) or (1, H, W, C) -> (H, W, C); a batch raises: the serving
    core matches batch rows to per-call stamps by position, so a
    pre-batched input would publish frames under the wrong stamps.
    Batching is the node's job (``microbatch``)."""
    if x.ndim == 4:
        if x.shape[0] != 1:
            raise ValueError(f"{what}; got a batch of {x.shape[0]} (batching "
                             "is the node's job, microbatch=M)")
        return x[0]
    return x


class _PinnedRing:
    """Pinned host buffers of one node, in a ring of slots: a slot is
    handed out again only after the host has waited on the event recorded
    after the copies that last used it. A shape's buffers are allocated at
    its first use, for every slot at once: allocating page-locked memory
    synchronizes the device, so a node in its steady state allocates
    none."""

    def __init__(self, slots: int):
        self._bufs = [{} for _ in range(slots)]
        self._events: List[Optional[torch.cuda.Event]] = [None] * slots
        self._next = 0

    def take(self) -> int:
        slot = self._next
        self._next = (slot + 1) % len(self._bufs)
        if self._events[slot] is not None:
            self._events[slot].synchronize()
        return slot

    def buffer(self, slot: int, key, make) -> torch.Tensor:
        """The slot's pinned buffer for ``key``; ``make()`` gives a
        pageable tensor of its shape and dtype at the key's first use."""
        if key not in self._bufs[slot]:
            for bufs in self._bufs:
                bufs[key] = make().pin_memory()
        return self._bufs[slot][key]

    def record(self, slot: int, stream) -> torch.cuda.Event:
        event = torch.cuda.Event()
        event.record(stream)
        self._events[slot] = event
        return event


class _OverlapMixin:
    """Frames-in-flight machinery shared by the DNN serving nodes.

    With ``overlap=N`` a call dispatches the current frame, starts its copy
    to the host, and waits only for the result dispatched N calls earlier:
    the card computes while the host prepares and dispatches the frames in
    between. The first N calls return None; afterwards each call returns
    `graph.Stamped` result(s) under their true source stamps.

    ``microbatch=M`` (with overlap) accumulates M frames on the host and
    dispatches them as one batch; a ready batch returns a list of
    `Stamped` results, which the graph publishes each under its own stamp.
    It trades up to M-1 frame periods of latency for fewer round trips.

    On the card each node owns one CUDA stream: its uploads, the model and
    the copy of the result run there (the kernels launch on the current
    stream), the stream waits once for the default stream that loaded the
    weights, and the host waits on a result's event only when the result
    is due. Every call runs under `torch.inference_mode()` on the caller's
    thread (grad mode is per thread, and the kernels refuse autograd)."""

    def _init_overlap(self, overlap: int, microbatch: int = 1) -> None:
        self.overlap = int(overlap)
        if self.overlap < 0:
            raise ValueError(f"overlap must be >= 0, got {overlap}")
        self.microbatch = max(1, int(microbatch))
        if self.microbatch > 1 and not self.overlap:
            raise ValueError("microbatch requires overlap >= 1")
        self.needs_stamp = self.overlap > 0
        self._inflight = collections.deque()
        self._batch = []  # (frame input, meta) accumulating to microbatch
        self._stream = None
        if self._device.type == "cuda":
            with on_device(self._device):
                self._stream = torch.cuda.Stream(self._device)
            # the weights were loaded on the default stream
            self._stream.wait_stream(
                torch.cuda.current_stream(self._device))
            self._uploads = _PinnedRing(self.overlap + self.microbatch + 1)
            # a result is copied out when it is popped, and at most
            # ``overlap`` are in flight when the next is queued, so its
            # slot's last result has been popped
            self._results = _PinnedRing(self.overlap + 1)

    def _on_stream(self):
        if self._stream is None:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(on_device(self._device))
        stack.enter_context(torch.cuda.stream(self._stream))
        return stack

    def _upload(self, inputs: List[List[np.ndarray]]) -> List[torch.Tensor]:
        """``inputs``: per model input, its rows (one host frame each) ->
        per input, one (rows, ...) tensor on the node's device; on the card
        copied from pinned staging buffers on the node's stream (call
        under it)."""
        if self._stream is None:
            return [torch.from_numpy(np.stack(rows)) for rows in inputs]
        slot = self._uploads.take()
        out = []
        for j, rows in enumerate(inputs):
            shape = (len(rows),) + rows[0].shape
            dtype = rows[0].dtype
            buf = self._uploads.buffer(
                slot, (j, shape, dtype.str),
                lambda: torch.from_numpy(np.empty(shape, dtype)))
            host = buf.numpy()
            for i, row in enumerate(rows):
                host[i] = row
            out.append(buf.to(self._device, non_blocking=True))
        self._uploads.record(slot, self._stream)
        return out

    def warmup(self, *inputs) -> None:
        """Exercise every path this serving configuration uses, then reset
        to empty queues: microbatch * (overlap + 1) calls reach both a full
        batch and a due result; a synchronous node gets one call."""
        for _ in range(self.microbatch * (self.overlap + 1)):
            self(*inputs)
        self.drain()

    def _queue(self, out: torch.Tensor, metas) -> None:
        """Start the copy of a dispatched batch to a pinned host buffer on
        the node's stream and queue it with its metas and the copy's
        event."""
        if self._stream is None:
            self._inflight.append((out, None, metas))
            return
        slot = self._results.take()
        host = self._results.buffer(
            slot, (tuple(out.shape), out.dtype),
            lambda: torch.empty(out.shape, dtype=out.dtype))
        host.copy_(out, non_blocking=True)
        self._inflight.append((host, self._results.record(slot,
                                                          self._stream),
                               metas))

    def _pop_ready(self):
        """Pop the oldest batch once more than ``overlap`` are queued,
        waiting for its copy; returns (host array, metas) or None. On the
        card the array is copied out of the pinned buffer, which a later
        dispatch reuses."""
        if len(self._inflight) <= self.overlap:
            return None
        host, event, metas = self._inflight.popleft()
        if event is None:
            return host.numpy(), metas
        event.synchronize()
        return host.numpy().copy(), metas

    def _serve(self, frame_input, meta, dispatch, finish, name,
               sync_name=None):
        """The serving core shared by the DNN nodes.

        ``frame_input``: this frame's host-prepared input, one row of the
        dispatched batch (the per-frame metas are matched to batch rows by
        position); ``meta``: per-frame metadata whose last element is the
        source stamp; ``dispatch(inputs)``: list of frame inputs -> device
        batch; ``finish(host_row, meta)``: one batch row -> host result.
        Returns None while the batch fills or the pipeline primes, else
        Stamped result(s). A synchronous node returns its result bare and
        times dispatch and fetch as one stage, ``sync_name`` (default
        ``name``), as the JAX nodes do."""
        self._batch.append((frame_input, meta))
        if len(self._batch) < self.microbatch:
            return None
        if not self.overlap:
            with self.profiler.stage(sync_name or name):
                self._dispatch(dispatch)
                res, metas = self._pop_ready()
            return finish(res[0], metas[0])
        with self.profiler.stage(f"{name}/dispatch"):
            self._dispatch(dispatch)
        with self.profiler.stage(f"{name}/fetch"):
            got = self._pop_ready()
        if got is None:
            return None
        res, metas = got
        outs = [Stamped(finish(res[i], m), m[-1])
                for i, m in enumerate(metas)]
        return outs if len(outs) > 1 else outs[0]

    def _dispatch(self, dispatch) -> None:
        inputs = [b[0] for b in self._batch]
        metas = [b[1] for b in self._batch]
        self._batch.clear()
        with self._on_stream():
            self._queue(dispatch(inputs), metas)

    def drain(self) -> None:
        """Wait for everything in flight and discard it (warm-up,
        shutdown); also discards a partial microbatch. The next call
        starts a fresh pipeline."""
        self._batch.clear()
        while self._inflight:
            _, event, _ = self._inflight.popleft()
            if event is not None:
                event.synchronize()

    def close(self) -> None:
        self.drain()


def tap_stage(node, on_result):
    """Wrap a serving node for `NodeGraph` so every result it produces also
    feeds ``on_result(data)`` (e.g. the controller's ``on_trailnet``)
    before publishing: unwraps `Stamped` and lists of them, and forwards
    ``needs_stamp`` so overlapped results keep their true stamps."""
    def stage(*frames, stamp=None):
        out = node(*frames, stamp=stamp) if node.needs_stamp \
            else node(*frames)
        for r in (out if isinstance(out, list)
                  else [out] if out is not None else []):
            on_result(r.data if isinstance(r, Stamped) else r)
        return out
    stage.needs_stamp = node.needs_stamp
    return stage


def _stamp(stamp: Optional[float]) -> float:
    return time.monotonic() if stamp is None else stamp


class StereoNode(_OverlapMixin):
    """Stereo disparity stage: ``node(left_bgr_u8, right_bgr_u8) -> disp``.

    ``params``: a `StereoNet` or the JAX package's nested numpy param dict.
    ``device``: ``None`` is the card; ``"cpu"`` runs on the CPU.
    ``overlap`` / ``microbatch``: frames in flight, see `_OverlapMixin`.
    ``wire``: the disparity's transport from the card. ``'f32'`` copies
    float32; ``'u16'`` copies round(disp * 64) as 16 bits and converts on
    the host, half the bytes at 1/64 px steps. As in the JAX package it
    saturates silently at 65535 / 64 = 1023.984375 px.

    ``quantize`` (with the numpy param tree): ``'w8'`` stores the conv
    weights as per-channel int8 and dequantizes them once, at load (the
    weight-only rung); ``'int8'`` also runs the 2D conv stacks as int8 x
    int8 with an exact integer sum (`quant/stereo_int8.py`), calibrated in
    fp32 on ``calib_frames``, uint8 BGR (left, right) pairs preprocessed as
    the JAX node does (bilinear resize if needed, RGB, /255). An int8 stem
    has no s2d form, so that node uploads raw RGB frames and the native
    pack stays off."""

    def __init__(self, spec: StereoSpec, params, *,
                 dtype: torch.dtype = torch.bfloat16,
                 quantize: Optional[str] = None, calib_frames=None,
                 profiler: Optional[StageProfiler] = None,
                 device=None, overlap: int = 0, microbatch: int = 1,
                 wire: str = "f32"):
        if wire not in ("f32", "u16"):
            raise ValueError(f"unknown wire format {wire!r}")
        if quantize not in (None, "w8", "int8"):
            raise ValueError(f"unknown quantize mode {quantize!r}")
        if quantize is not None and isinstance(params, StereoNet):
            raise ValueError("quantize takes the numpy param tree, not a "
                             "StereoNet")
        self._device = _stage_device(device)
        self.spec = spec
        self.profiler = profiler or StageProfiler()
        self._dtype = dtype
        self._wire = wire
        self._hw = tuple(spec.input_hw)
        if quantize == "int8":
            if not calib_frames:
                raise ValueError("quantize='int8' requires calib_frames")
            pairs = [(_calib_frame(l, self._hw), _calib_frame(r, self._hw))
                     for l, r in calib_frames]
            with on_device(self._device):
                scales = calibrate_stereo(spec, params, pairs,
                                          device=self._device)
            params = quantize_stereo_params_int8(params, scales)
        elif quantize == "w8":
            params = dequantize_tree(quantize_stereo_params_w8(params))
        # s2d frames for a float stem unless REDTAIL_TPU_S2D=0; an int8
        # stem has no s2d form (JAX: use_s2d_stem() and not int8)
        self._s2d = use_s2d_stem() and quantize != "int8"
        if isinstance(params, StereoNet) and params.dtype != dtype:
            raise ValueError(f"the StereoNet was built in {params.dtype}; "
                             f"this node serves {dtype}")
        with on_device(self._device):
            if isinstance(params, StereoNet):
                self.net = params.to(device=self._device)
            else:
                self.net = params_from_numpy(spec, params,
                                             device=self._device,
                                             dtype=dtype)
        self._init_overlap(overlap, microbatch)

    def _host_prep(self, x_u8: np.ndarray) -> np.ndarray:
        """Resize if needed, then BGR -> RGB and s2d pack in one native
        pass, on host uint8 (bit-identical numpy fallback); for an int8
        stem only the resize and BGR -> RGB."""
        x_u8 = _host_resize(x_u8, self._hw, interpolation="area")
        if not self._s2d:
            return np.ascontiguousarray(x_u8[..., ::-1])
        return native.pack_s2d(x_u8, swap_rb=True)

    def _run(self, inputs) -> torch.Tensor:
        """The dispatch of a batch, in two stages: ``upload`` (the pinned
        ring's wait, the copy into it, the H2D enqueue) and ``enqueue``
        (the normalization, the forward and the wire conversion)."""
        name = f"stereo/{self.spec.name}"
        with self.profiler.stage(f"{name}/upload"):
            left, right = self._upload([[i[0] for i in inputs],
                                        [i[1] for i in inputs]])
        with self.profiler.stage(f"{name}/enqueue"):
            disp = self.net(*((x.float() / 255.0).to(self._dtype)
                              for x in (left, right)))
            if self.spec.corr:  # sigmoid-normalized: x width -> pixels
                disp = disp * self._hw[1]
            if self._wire == "u16":
                # round half to even and clip as jnp does, in int32; int16
                # carries the 16 bits (uint16 has few ops on the card)
                q = torch.round(disp.float() * 64.0).clamp_(0, 65535).int()
                return torch.where(q > 32767, q - 65536, q).to(torch.int16)
            return disp.float()

    def _from_wire(self, disp: np.ndarray) -> np.ndarray:
        if self._wire == "u16":
            return disp.view(np.uint16).astype(np.float32) / 64.0
        return disp

    @torch.inference_mode()
    def __call__(self, left_u8, right_u8, stamp: Optional[float] = None):
        what = ("StereoNode serves one frame pair per call ((H, W, 3) or "
                "(1, H, W, 3))")
        left_u8 = _one_frame(np.asarray(left_u8), what)
        right_u8 = _one_frame(np.asarray(right_u8), what)
        name = f"stereo/{self.spec.name}"
        with self.profiler.stage(f"{name}/pack"):
            frame = (self._host_prep(left_u8), self._host_prep(right_u8))
        return self._serve(frame, (_stamp(stamp),), self._run,
                           lambda row, m: self._from_wire(row), name)


class VizNode:
    """Disparity-mosaic sink, the `stereo_dnn_ros_viz` node
    (`stereo_dnn_ros_viz_node.cpp:202-219`): 3-way-synced (left, right,
    disparity) -> 2x2 mosaic [L | R ; gray | KITTI-color], written to
    ``out_dir`` every ``every``-th frame (with `cv2`, imported then).

    ``max_disp`` defaults to 96 like the reference's hardcoded value
    (`stereo_dnn_ros_viz_node.cpp:111`)."""

    def __init__(self, out_dir, *, max_disp: float = 96.0, every: int = 10,
                 profiler: Optional[StageProfiler] = None):
        import pathlib
        self.out_dir = pathlib.Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.max_disp = max_disp
        self.every = max(1, every)
        self.profiler = profiler or StageProfiler()
        self.frames = 0
        self.written = 0

    def __call__(self, left_bgr, right_bgr, disp) -> None:
        from redtail_tpu_torch.runtime.viz import make_mosaic
        self.frames += 1
        if (self.frames - 1) % self.every:
            return None  # build only the mosaics that are written
        with self.profiler.stage("viz"):
            mosaic = make_mosaic(np.asarray(left_bgr)[..., ::-1],
                                 np.asarray(right_bgr)[..., ::-1],
                                 np.asarray(disp, np.float32),
                                 self.max_disp)
            import cv2
            path = self.out_dir / f"mosaic_{self.written:05d}.png"
            cv2.imwrite(str(path), mosaic[..., ::-1])  # RGB -> BGR
            self.written += 1
        return None


class _CaffeStage(_OverlapMixin):
    """The shared dispatch of the Caffe-graph nodes: uint8 frames up (at
    the net's size: the host resized them), the cast to the net's dtype,
    the net, its output to the host in float32."""

    def _run(self, frames) -> torch.Tensor:
        (x,) = self._upload([frames])
        return self.net(x.to(self.net.dtype)).float()


class TrailNetNode(_CaffeStage):
    """TrailNet stage: ``node(frame_bgr_u8) -> (6,)`` float32 probabilities
    (the orientation softmax, then the lateral-offset softmax).

    ``net``: a `CaffeNet` over a TrailNet prototxt or a native `TrailNet`,
    served in its own dtype; ``None`` loads `load_trailnet()`'s default
    prototxt, the reference's, which this repository does not hold (as in
    the JAX package). ``device``: ``None`` is the card; ``"cpu"`` runs on
    the CPU. ``overlap`` / ``microbatch``: see `_OverlapMixin`."""

    def __init__(self, net=None, *, profiler: Optional[StageProfiler] = None,
                 device=None, overlap: int = 0, microbatch: int = 1):
        self._device = _stage_device(device)
        with on_device(self._device):
            if net is None:
                net = load_trailnet(device=self._device)
            self.net = net.to(self._device)
        self.profiler = profiler or StageProfiler()
        self._hw = INPUT_HW
        self._init_overlap(overlap, microbatch)

    @torch.inference_mode()
    def __call__(self, frame_u8, stamp: Optional[float] = None):
        frame_u8 = _one_frame(np.asarray(frame_u8),
                              "TrailNetNode serves one frame per call "
                              "((H, W, 3) or (1, H, W, 3))")
        with self.profiler.stage("trailnet/pack"):
            frame_u8 = _host_resize(frame_u8, self._hw,
                                    interpolation="cubic")
        return self._serve(frame_u8, (_stamp(stamp),), self._run,
                           lambda row, m: row, "trailnet")


class YoloNode(_CaffeStage):
    """YOLO stage: ``node(frame_bgr_u8) -> (n, 6)`` float32 detections
    [label, prob, x, y, w, h] in the frame's own pixels (`caffe_ros.cpp:
    155-189`).

    ``net``: a `CaffeNet` taking 448x448 frames to the (1470,) YOLOv1 head.
    ``device``: ``None`` is the card; ``"cpu"`` runs on the CPU.
    ``overlap``: see `_OverlapMixin` (no microbatch, as in JAX)."""

    INPUT_HW = (448, 448)

    def __init__(self, net, *, prob_threshold: float = 0.15,
                 iou_threshold: float = 0.2,
                 profiler: Optional[StageProfiler] = None,
                 device=None, overlap: int = 0):
        self._device = _stage_device(device)
        with on_device(self._device):
            self.net = net.to(self._device)
        self._hw = self.INPUT_HW
        self.prob_threshold = prob_threshold
        self.iou_threshold = iou_threshold
        self.profiler = profiler or StageProfiler()
        self._init_overlap(overlap)

    def _finish(self, raw: np.ndarray, meta) -> np.ndarray:
        with self.profiler.stage("yolo/postproc"):
            return yolo.postprocess(raw, meta[0], meta[1],
                                    prob_threshold=self.prob_threshold,
                                    iou_threshold=self.iou_threshold)

    @torch.inference_mode()
    def __call__(self, frame_u8, stamp: Optional[float] = None):
        frame_u8 = _one_frame(np.asarray(frame_u8),
                              "YoloNode serves one frame per call")
        h, w = frame_u8.shape[:2]
        frame_u8 = _host_resize(frame_u8, self._hw, interpolation="cubic")
        return self._serve(frame_u8, (w, h, _stamp(stamp)), self._run,
                           self._finish, "yolo", sync_name="yolo/dnn")
