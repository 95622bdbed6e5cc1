"""TF-semantics 2D/3D convolution and transposed convolution
(`redtail_tpu/ops/convolution.py`).

The public functions keep the JAX package's layouts: NHWC / NDHWC
activations and HWIO / DHWIO weights (for a transpose, I = its output
channels, as TF stores them). The model calls the `*_nchw` / `*_ncdhw`
forms on NCHW / NCDHW tensors in `torch.channels_last` /
`torch.channels_last_3d` memory (NHWC / NDHWC in memory, so no copies)
with weights moved to PyTorch's layout once at load.

The convolutions themselves are cuDNN's (on the CPU, PyTorch's), as the JAX
package leaves them to XLA (its `native` conv3d and `dilated` transposes).
What is TF's is arranged around them:

- TF-SAME padding is resolved per dim as (lo, hi); symmetric pads go to
  the conv, and an asymmetric one (stride 2 on an even size, e.g. D = 48
  pads (0, 1)) is an explicit zero pad of the input with ``padding=0``;
- a transposed conv is cropped to ``out_spatial`` at the forward conv's
  low pad;
- every convolution rounds once, as JAX's do (an fp32 sum, the bias
  added in fp32, one cast to the input dtype): a bf16 conv runs on fp32
  carriers of its operands with TF32 allowed, exact in its products since
  every bf16 value is a TF32 value (`_fp32_accumulate`), and its fp32
  output takes the bias before the one cast. The model passes weights
  already widened at load, so a frame widens only the activations. (cuDNN's
  own bf16 conv would return a rounded sum, and the bias added after it
  would round a second time.) TrailNet's and the Caffe interpreter's
  `conv2d_round_once` is the same arithmetic with Caffe's explicit pads;
- fp32 convolutions run in full fp32, as JAX's ``Precision.HIGHEST``:
  cuDNN would otherwise use TF32, so `_fp32_accumulate` turns TF32 off
  (cuDNN and matmul flags) around each fp32 CUDA conv and restores it
  after. Those flags are process-wide: one lock (`_FLAGS_LOCK`) spans
  each set, launch and restore, so a node thread's conv never launches
  under another node thread's setting.
- the convolutions are differentiable with JAX's mixed-precision rule
  (`redtail_tpu/ops/convolution.py:_mixed_accum_conv`): where an operand
  requires grad, the fp32 sum is `_ConvSum`, whose backward casts the
  cotangent to the layer's dtype, runs cuDNN's input and weight gradients
  on fp32 copies under the same switches (taken inside the backward, on
  whatever thread autograd runs it: the lock is never held across
  ``loss.backward()``), and rounds each gradient once to the operand
  dtype. A trainable net's fp32 master weight is rounded to the layer's
  dtype inside `_ConvSum` (its gradient rounded there too), its bias in
  `_add_bias`. The bias and the final cast stay autograd's.

`plain_lowering` is the JAX package's switch to the spec-literal forms; in
the port it selects the explicit concat volume + dense conv3D_1 over the
fused cost volume + conv3D_1 (`models/stereo.py`).

`ops.halo.sharded_axis(group, axis, global_size)` runs the convs of a
block on shards (`parallel/sharding.py`, where the JAX package lets GSPMD
partition them): each rank of ``group`` holds its rows of one axis
(``axis`` -2, H, or -3, D, of NCHW / NCDHW tensors) under the ownership
rule of `ops/halo.py`, ``global_size`` the axis's size for the block's
inputs (`sharded_extent` moves it from layer to layer). A conv there takes its
TF-SAME pads from the global size, fetches the input rows its own output
rows read (`ops.halo.exchange`), convolves that slab with no pad on
the axis and returns exactly its own output rows; a transposed conv takes
its global ``out_spatial`` and returns its own rows of it. A rank that owns
no output rows takes part in the exchange and returns an empty shard
(tied to the exchange's output, so its backward runs on every rank).
Outside the block nothing changes. `packed3d_lowering`
selects the packed 3D head (`ops/packed3d.py`), whose final c_out = 1
deconv on the card is `conv3d_transpose_dfold`: the transposed conv with D
folded into channels, one k=2 `F.conv2d` per block of output depths.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import threading
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from redtail_tpu_torch.kernels import conv3d_k3 as _k3
from redtail_tpu_torch.kernels import deconv3d_s2 as _d2
from redtail_tpu_torch.kernels._build import needs_grad
from redtail_tpu_torch.ops.activations import elu
from redtail_tpu_torch.ops.halo import (ShardedAxis, current_sharding,
                                       empty_shard, fetch, halo_rows,
                                       image_sharding, window_rows,
                                       window_size)

Strides = Union[int, Sequence[int]]

_PLAIN_LOWERING = contextvars.ContextVar("redtail_torch_plain_lowering",
                                         default=False)
_PACKED3D = contextvars.ContextVar("redtail_torch_packed3d", default=False)


@contextlib.contextmanager
def plain_lowering():
    """Run the spec-literal lowerings inside the block: every layer is the
    one conv the spec names (no fused cost volume + conv3D_1)."""
    token = _PLAIN_LOWERING.set(True)
    try:
        yield
    finally:
        _PLAIN_LOWERING.reset(token)


def use_plain_lowering() -> bool:
    return _PLAIN_LOWERING.get()


@contextlib.contextmanager
def packed3d_lowering():
    """Run the 3D models' packed head inside the block (`use_packed3d`)."""
    token = _PACKED3D.set(True)
    try:
        yield
    finally:
        _PACKED3D.reset(token)


def use_packed3d() -> bool:
    """Whether the 3D models run the packed head: inside
    `packed3d_lowering()`, or where ``REDTAIL_TPU_PACKED3D=1`` (the JAX
    package's switch; ``0`` or unset is off: the fused unpacked head is the
    port's default). `plain_lowering()` wins over both."""
    if use_plain_lowering():
        return False
    return _PACKED3D.get() or os.environ.get("REDTAIL_TPU_PACKED3D") == "1"


def _sharded_dim(x: torch.Tensor) -> Tuple[Optional[ShardedAxis], int]:
    """(the sharding, the spatial index of its axis in ``x``) or (None,
    -1); ``x`` is NCHW / NCDHW (the packed ops' NDHWC tensors name their
    axis themselves)."""
    sh = current_sharding()
    if sh is None:
        return None, -1
    sd = x.dim() + sh.axis - 2
    if sd < 0:
        raise ValueError(f"a {x.dim()}-D tensor has no axis {sh.axis} to "
                         "shard")
    return sh, sd


def sharded_conv_input(x: torch.Tensor, ksize: Sequence[int],
                       strides: Sequence[int], padding: str = "SAME"):
    """The TF pads of a conv over channels-first ``x`` (kernel ``ksize``,
    ``strides``), and inside `sharded_axis` the slab its own output rows
    read (`halo_rows`, the pads from the axis's global size): (x or the
    slab, per-dim (lo, hi) pads, None or (the sharded spatial dim, a, b))."""
    pads = [tf_same_padding(i, k, s) if padding == "SAME" else (0, 0)
            for i, k, s in zip(x.shape[2:], ksize, strides)]
    sh, sd = _sharded_dim(x)
    if sh is None:
        return x, pads, None
    g, k, s = sh.global_size, ksize[sd], strides[sd]
    x, pads[sd], (a, b) = halo_rows(
        x, sh, 2 + sd, global_size=g, k=k, s=s,
        pads=tf_same_padding(g, k, s) if padding == "SAME" else (0, 0))
    return x, pads, (sd, a, b)


def empty_conv_shard(x: torch.Tensor, out_channels: int, ksize, strides,
                     pads, sd: int, dtype) -> torch.Tensor:
    """The empty output shard of a conv over the slab ``x`` whose rank owns
    no rows of spatial dim ``sd``."""
    shape = [x.shape[0], out_channels]
    for i, (n, k, s, p) in enumerate(zip(x.shape[2:], ksize, strides,
                                         pads)):
        shape.append(0 if i == sd else window_size(n, k, s, p))
    return empty_shard(x, shape, dtype)


def tf_same_padding(in_dim: int, kern_dim: int,
                    stride_dim: int) -> Tuple[int, int]:
    """TF ``SAME`` padding (lo, hi) for one dim."""
    if in_dim % stride_dim == 0:
        pad_along = max(kern_dim - stride_dim, 0)
    else:
        pad_along = max(kern_dim - (in_dim % stride_dim), 0)
    pad_start = pad_along // 2
    return pad_start, pad_along - pad_start


# The TF32 setting each CUDA conv asks for inside `record_switches()`.
_SWITCH_LOG = contextvars.ContextVar("redtail_torch_switch_log",
                                     default=None)


@contextlib.contextmanager
def record_switches():
    """Yield a list that collects, inside the block, the TF32 setting
    (``allow``) of each CUDA conv's `_tf32`: what an exported engine, whose
    graph keeps the convs but not these Python-side switches, must set
    around its calls (`runtime/cache.py`)."""
    log = []
    token = _SWITCH_LOG.set(log)
    try:
        yield log
    finally:
        _SWITCH_LOG.reset(token)


# cuDNN's and cuBLAS's TF32 and determinism switches are process-wide, and
# the serving nodes run on threads of their own (a bf16 StereoNode beside an
# fp32 TrailNetNode in `pipeline_app`), with the GIL dropped inside a conv:
# one lock spans setting the switches, the launch that reads them and their
# restore, so no conv of the port launches under another thread's setting.
_FLAGS_LOCK = threading.RLock()


@contextlib.contextmanager
def _tf32(x: torch.Tensor, allow: bool):
    """cuDNN's and cuBLAS's TF32 switches set to ``allow`` around CUDA work
    on ``x``, and cuDNN held to its deterministic algorithms (a frame
    served twice gives the same bits, as on the TPU; some fp32 transposed
    convs otherwise sum with atomics), restored after, all under
    `_FLAGS_LOCK`; nothing on the CPU."""
    if not x.is_cuda:
        yield
        return
    log = _SWITCH_LOG.get()
    if log is not None:
        log.append(allow)
    with _FLAGS_LOCK:
        saved = (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.deterministic)
        torch.backends.cudnn.allow_tf32 = allow
        torch.backends.cuda.matmul.allow_tf32 = allow
        torch.backends.cudnn.deterministic = True
        try:
            yield
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic) = saved


def _fp32_accumulate(x: torch.Tensor):
    """Where a conv or matmul on fp32 copies of ``x``'s dtype is exact in
    its products: TF32 off for fp32 (JAX's ``Precision.HIGHEST``), allowed
    for bf16, whose every value is exact in TF32."""
    return _tf32(x, x.dtype != torch.float32)


_CONV = {4: F.conv2d, 5: F.conv3d}
_CONV_T = {4: F.conv_transpose2d, 5: F.conv_transpose3d}


def _conv_fp32(x, w, stride, padding, transposed):
    fn = (_CONV_T if transposed else _CONV)[x.dim()]
    with _fp32_accumulate(x):
        return fn(x.float(), w.float(), stride=stride, padding=padding)


class _ConvSum(torch.autograd.Function):
    """The fp32 sum of a conv (or transposed conv) over fp32 copies of its
    operands, differentiable as JAX's `_mixed_accum_conv` is: the
    cotangent cast to x's dtype, the input and weight gradients as fp32
    sums (cuDNN, the forward's TF32 and determinism switches, taken here,
    inside the backward), each rounded once to x's dtype. A weight held in
    another dtype (a trainable net's fp32 master) is rounded to x's dtype
    here, in the forward, and its gradient returned in its own dtype: the
    one cast each way that JAX's train step makes of its params."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, transposed):
        wc = w.to(x.dtype).float()
        ctx.save_for_backward(x, wc)
        ctx.conf = (stride, padding, transposed, w.dtype)
        return _conv_fp32(x, wc, stride, padding, transposed)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, wc = ctx.saved_tensors
        stride, padding, transposed, w_dtype = ctx.conf
        nd = x.dim() - 2
        g = g.to(x.dtype).float()
        with _fp32_accumulate(x):
            dx, dw, _ = torch.ops.aten.convolution_backward(
                g, x.float(), wc, None, _tuple(stride, nd),
                _tuple(padding, nd), (1,) * nd, transposed, (0,) * nd, 1,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        if dx is not None:
            dx = dx.to(x.dtype)
        if dw is not None:
            dw = dw.to(x.dtype).to(w_dtype)
        return dx, dw, None, None, None


def _conv_sum(x: torch.Tensor, w: torch.Tensor, stride, padding,
              transposed: bool = False) -> torch.Tensor:
    """The fp32 conv sum of x and w (no bias), through `_ConvSum` where
    grad mode is on and an operand requires grad. A weight that requires
    grad (a trainable master) is rounded to x's dtype; a frozen one is a
    carrier made at load and taken as it is."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _ConvSum.apply(x, w, stride, padding, transposed)
    if w.requires_grad:
        w = w.to(x.dtype)
    return _conv_fp32(x, w, stride, padding, transposed)


def conv2d_round_once(x: torch.Tensor, w: torch.Tensor,
                      b: Optional[torch.Tensor], stride: Strides,
                      padding: Tuple[int, int]) -> torch.Tensor:
    """Caffe's convolution with JAX's numerics (`redtail_tpu/models/
    caffe_net.py:_conv`, `trailnet.py:c2d`): x (N, C, H, W), w (O, I, kh,
    kw), symmetric explicit ``padding``, floor output dims; the conv runs on
    fp32 copies of the operands (fp32 sums), the bias is added in fp32 and
    the result is rounded once to x's dtype. The bias is added after the
    sum, as JAX's `c2d` adds it."""
    return _add_bias(_conv_sum(x, w, stride, padding), b, x.dtype)


def linear_fp32(x: torch.Tensor, w: torch.Tensor,
                b: Optional[torch.Tensor]) -> torch.Tensor:
    """x (N, I) @ w (O, I)^T + b in fp32 from fp32 copies of the operands
    (JAX's ``preferred_element_type=float32`` dot); the caller rounds."""
    with _fp32_accumulate(x):
        return F.linear(x.float(), w.float(),
                        None if b is None else b.float())


def _add_bias(out: torch.Tensor, b: Optional[torch.Tensor],
              dtype: torch.dtype) -> torch.Tensor:
    """The fp32 conv sum ``out`` + bias over axis 1, in fp32, then one cast
    to ``dtype``."""
    if b is None:
        return out.to(dtype)
    if b.requires_grad:  # a trainable master: rounded to the net's dtype
        b = b.to(dtype)
    return (out.float() + b.float().reshape(-1, *[1] * (out.dim() - 2))
            ).to(dtype)


def _tuple(strides: Strides, n: int) -> Tuple[int, ...]:
    return (int(strides),) * n if isinstance(strides, int) else tuple(strides)


def _padding(padding: str) -> str:
    if padding.upper() not in ("SAME", "VALID"):
        raise ValueError(f"unknown padding {padding!r}")
    return padding.upper()


def _conv(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
          strides: Strides, padding: str) -> torch.Tensor:
    """TF conv over channels-first x (N, C, *S) with w (O, I, *k); inside
    `sharded_axis`, on this rank's rows (see the module docstring)."""
    padding = _padding(padding)
    strides = _tuple(strides, x.dim() - 2)
    x, pads, own = sharded_conv_input(x, w.shape[2:], strides, padding)
    if own is not None and own[1] == own[2]:
        return empty_conv_shard(x, w.shape[0], w.shape[2:], strides, pads,
                                own[0], x.dtype)
    if all(lo == hi for lo, hi in pads):
        conv_pad = tuple(lo for lo, _ in pads)
    else:
        x = F.pad(x, [p for pair in reversed(pads) for p in pair])
        conv_pad = 0
    return _add_bias(_conv_sum(x, w, strides, conv_pad), b, x.dtype)


def _conv_transpose(y: torch.Tensor, w: torch.Tensor,
                    b: Optional[torch.Tensor], out_spatial: Sequence[int],
                    strides: Strides, padding: str) -> torch.Tensor:
    """TF ``conv{2,3}d_transpose``: the gradient of the forward conv that
    maps ``out_spatial`` to y's size. y (N, K, *Y), w (K, C, *k). Inside
    `sharded_axis`, ``out_spatial`` is global and the result is this rank's
    rows of it."""
    padding = _padding(padding)
    strides = _tuple(strides, y.dim() - 2)
    sh, sd = _sharded_dim(y)
    own = None
    if sh is not None:
        k, s, g = w.shape[2 + sd], strides[sd], sh.global_size
        g_out = out_spatial[sd]
        lo = tf_same_padding(g_out, k, s)[0] if padding == "SAME" else 0
        # the transposed conv is a conv of y dilated by s with the flipped
        # kernel, padded (k - 1 - lo, ...) to g_out rows
        y, pads, (a, b_) = halo_rows(
            y, sh, 2 + sd, global_size=g, k=k, dil=s,
            pads=(k - 1 - lo, g_out + lo - (g - 1) * s - 1))
        if b_ == a:
            shape = [y.shape[0], w.shape[1], *out_spatial]
            shape[2 + sd] = 0
            return empty_shard(y, shape, y.dtype)
        # row a is row k - 1 - pads[0] of the unpadded transposed conv
        own = (k - 1 - pads[0], b_ - a)
    full = _conv_sum(y, w, strides, 0, transposed=True)
    crop = []
    for i, (size, full_size, k, s) in enumerate(zip(
            out_spatial, full.shape[2:], w.shape[2:], strides)):
        lo = tf_same_padding(size, k, s)[0] if padding == "SAME" else 0
        if i == sd:
            lo, size = own
        if lo + size > full_size:
            raise ValueError(f"out_spatial {tuple(out_spatial)} is not a "
                             f"TF-{padding} output for input "
                             f"{tuple(y.shape[2:])}")
        crop.append(slice(lo, lo + size))
    return _add_bias(full[(slice(None), slice(None), *crop)], b, y.dtype)


def conv2d_nchw(x: torch.Tensor, w: torch.Tensor,
                b: Optional[torch.Tensor] = None,
                stride: Strides = 1) -> torch.Tensor:
    """TF-SAME conv: x (N, C, H, W), w (O, I, kh, kw) -> (N, O, H', W')."""
    return _conv(x, w, b, stride, "SAME")


def conv3d_ncdhw(x: torch.Tensor, w: torch.Tensor,
                 b: Optional[torch.Tensor] = None, stride: Strides = 1,
                 padding: str = "SAME") -> torch.Tensor:
    """TF conv3d: x (N, C, D, H, W), w (O, I, kd, kh, kw)."""
    return _conv(x, w, b, stride, padding)


def conv3d_k3_routes(x: torch.Tensor, w: torch.Tensor, stride: Strides,
                     kernel_kc: Optional[torch.Tensor]) -> bool:
    """Whether ``elu(conv3d_ncdhw(x, w, b, stride))`` launches the
    hand-written kernel `kernels/conv3d_k3.py` (`conv3d_elu_ncdhw`): CUDA
    bf16 x (N, C, D, H, W), a 3x3x3 kernel at stride 1 (TF-SAME) held in
    the kernel's form ``kernel_kc``, grad required of neither operand, no
    `sharded_axis` in force, C and K in `conv3d_k3.CHANNELS`."""
    return (kernel_kc is not None and x.is_cuda
            and x.dtype == torch.bfloat16 and x.dim() == 5
            and _tuple(stride, 3) == (1, 1, 1)
            and tuple(w.shape[2:]) == (3, 3, 3)
            and x.shape[1] in _k3.CHANNELS and w.shape[0] in _k3.CHANNELS
            and not needs_grad(x, w)
            and current_sharding() is None)


def conv3d_elu_ncdhw(x: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor, stride: Strides = 1,
                     kernel_kc: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """``elu(conv3d_ncdhw(x, w, b, stride))``, a 3D encoder layer: one
    launch of the kernel `conv3d_k3` where `conv3d_k3_routes` holds
    (``kernel_kc`` is w in `conv3d_k3.kernel_weights`' form, made at load;
    the result an (N, K, D, H, W) view of NDHWC memory), else the
    round-once conv and the ELU."""
    if conv3d_k3_routes(x, w, stride, kernel_kc):
        return _k3.conv3d_k3(x.permute(0, 2, 3, 4, 1).contiguous(),
                             kernel_kc, b).permute(0, 4, 1, 2, 3)
    return elu(conv3d_ncdhw(x, w, b, stride))


def conv2d_transpose_nchw(y: torch.Tensor, w: torch.Tensor,
                          b: Optional[torch.Tensor] = None, *,
                          out_spatial: Sequence[int],
                          stride: Strides = 2) -> torch.Tensor:
    """TF ``conv2d_transpose`` (SAME): y (N, K, Y, X), w (K, C, kh, kw) ->
    (N, C, *out_spatial)."""
    return _conv_transpose(y, w, b, out_spatial, stride, "SAME")


def conv3d_transpose_ncdhw(y: torch.Tensor, w: torch.Tensor,
                           b: Optional[torch.Tensor] = None, *,
                           out_spatial: Sequence[int],
                           stride: Strides = 2,
                           padding: str = "SAME") -> torch.Tensor:
    """TF ``conv3d_transpose``: y (N, K, *Y), w (K, C, kd, kh, kw) ->
    (N, C, *out_spatial)."""
    return _conv_transpose(y, w, b, out_spatial, stride, padding)


def deconv3d_s2_routes(y: torch.Tensor, w: torch.Tensor,
                       skip: Optional[torch.Tensor], out_spatial: Sequence[int],
                       stride: Strides, kernel_s2: Optional[torch.Tensor],
                       padding: str = "SAME") -> bool:
    """Whether a decoder layer's transposed conv (with ``skip``: ``elu(
    conv3d_transpose_ncdhw(y, w, b) + skip)``) launches the hand-written
    kernel `kernels/deconv3d_s2.py` (`deconv3d_s2_ncdhw`): CUDA bf16 y (N,
    C, D, H, W), a 3x3x3 kernel at stride 2, TF-SAME, held in the kernel's
    form ``kernel_s2``, each extent of y ceil(out / 2), grad required of no
    operand, no `sharded_axis` in force, C in `deconv3d_s2.CHANNELS`, c_out
    in `deconv3d_s2.OUT_CHANNELS`, a bf16 skip exactly where c_out > 1."""
    c_out = w.shape[1]
    return (kernel_s2 is not None and y.is_cuda
            and y.dtype == torch.bfloat16 and y.dim() == 5
            and _tuple(stride, 3) == (2, 2, 2)
            and tuple(w.shape[2:]) == (3, 3, 3)
            and _padding(padding) == "SAME"
            and len(out_spatial) == 3
            and all(-(-x // 2) == v for x, v in zip(out_spatial,
                                                     y.shape[2:]))
            and y.shape[1] in _d2.CHANNELS and c_out in _d2.OUT_CHANNELS
            and (skip is None) == (c_out == 1)
            and (skip is None or (skip.dtype == torch.bfloat16
                                  and skip.device == y.device))
            and not needs_grad(y, w, skip)
            and current_sharding() is None)


def deconv3d_s2_ncdhw(y: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                      skip: Optional[torch.Tensor] = None, *,
                      out_spatial: Sequence[int],
                      kernel_s2: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """A 3D decoder layer, stride 2, TF-SAME: ``elu(conv3d_transpose_ncdhw(
    y, w, b) + skip)``, or without ``skip`` the transposed conv alone. One
    launch of the kernel `deconv3d_s2` where `deconv3d_s2_routes` holds
    (``kernel_s2`` is w in `deconv3d_s2.kernel_weights`' form, made at
    load; the result an (N, c_out, *out_spatial) view of NDHWC memory),
    else the round-once transposed conv, then the skip add and the ELU."""
    if deconv3d_s2_routes(y, w, skip, out_spatial, 2, kernel_s2):
        ndhwc = (0, 2, 3, 4, 1)
        return _d2.deconv3d_s2(
            y.permute(*ndhwc).contiguous(), kernel_s2, b,
            None if skip is None else skip.permute(*ndhwc).contiguous(),
            out_spatial).permute(0, 4, 1, 2, 3)
    out = conv3d_transpose_ncdhw(y, w, b, out_spatial=out_spatial, stride=2)
    return out if skip is None else elu(out + skip)


def _square(strides) -> int:
    if strides[0] != strides[1]:
        raise ValueError(f"square strides only, got {strides}")
    return strides[0]


def conv2d(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None, *,
           strides: Tuple[int, int] = (1, 1)) -> torch.Tensor:
    """2D convolution, NHWC activations, HWIO weights, TF ``SAME``."""
    out = conv2d_nchw(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), b,
                      _square(strides))
    return out.permute(0, 2, 3, 1)


TRANSPOSE_IMPLS = ("dilated", "shuffle", "dfold")


def _transpose_impl(impl: Optional[str], nd: int, w: torch.Tensor,
                    strides) -> str:
    """``impl`` checked: None is ``"dilated"`` (cuDNN's transposed conv,
    the port's choice on the card); the decompositions take k=3, stride 2
    only, ``"dfold"`` in 3D only."""
    impl = impl or "dilated"
    if impl not in TRANSPOSE_IMPLS or (impl == "dfold" and nd == 2):
        raise ValueError(f"unknown {nd}D transpose impl {impl!r}")
    if impl != "dilated" and (tuple(w.shape[:nd]) != (3,) * nd
                              or tuple(strides) != (2,) * nd):
        raise ValueError(f"the {impl} transpose takes a k=3 stride-2 "
                         f"kernel, got {tuple(w.shape)} at {strides}")
    return impl


def conv2d_transpose(y: torch.Tensor, w: torch.Tensor,
                     b: Optional[torch.Tensor] = None, *,
                     out_spatial: Sequence[int],
                     strides: Tuple[int, int] = (2, 2),
                     impl: Optional[str] = None) -> torch.Tensor:
    """TF ``conv2d_transpose``: NHWC activations, HWIO weights with
    I = output channels of the transpose and O = its input channels.

    ``impl``: ``"dilated"`` (None; cuDNN's transposed conv) or
    ``"shuffle"`` (`conv2d_transpose_shuffle`, k=3 stride 2 SAME)."""
    if _transpose_impl(impl, 2, w, strides) == "shuffle":
        return conv2d_transpose_shuffle(y, w, b, out_spatial=out_spatial)
    out = conv2d_transpose_nchw(y.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                                b, out_spatial=out_spatial,
                                stride=_square(strides))
    return out.permute(0, 2, 3, 1)


def conv3d(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None, *,
           strides: Tuple[int, int, int] = (1, 1, 1),
           padding: str = "SAME") -> torch.Tensor:
    """3D convolution, NDHWC activations, DHWIO weights, TF padding."""
    out = conv3d_ncdhw(x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2), b,
                       tuple(strides), padding)
    return out.permute(0, 2, 3, 4, 1)


def conv3d_transpose(y: torch.Tensor, w: torch.Tensor,
                     b: Optional[torch.Tensor] = None, *,
                     out_spatial: Sequence[int],
                     strides: Tuple[int, int, int] = (2, 2, 2),
                     padding: str = "SAME",
                     impl: Optional[str] = None) -> torch.Tensor:
    """TF ``conv3d_transpose``: NDHWC activations, DHWIO weights with
    I = output channels of the transpose and O = its input channels.

    ``impl``: ``"dilated"`` (None; cuDNN's transposed conv), ``"shuffle"``
    (`conv3d_transpose_shuffle`) or ``"dfold"`` (`conv3d_transpose_dfold`),
    the last two k=3 stride 2 SAME only."""
    impl = _transpose_impl(impl, 3, w, strides)
    if impl != "dilated" and _padding(padding) != "SAME":
        raise ValueError(f"the {impl} transpose is TF-SAME only")
    if impl == "shuffle":
        return conv3d_transpose_shuffle(y, w, b, out_spatial=out_spatial)
    if impl == "dfold":
        return conv3d_transpose_dfold(y, w, b, out_spatial=out_spatial)
    out = conv3d_transpose_ncdhw(
        y.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2), b,
        out_spatial=out_spatial, stride=tuple(strides), padding=padding)
    return out.permute(0, 2, 3, 4, 1)


# ------------------------------------------------ D-folded transposed conv


def _weave_axis(even: torch.Tensor, odd: torch.Tensor, axis: int,
                out_size: int) -> torch.Tensor:
    """Interleave two equal-rank tensors along ``axis``: out[2j] = even[j],
    out[2j+1] = odd[j]; pads the shorter parity and slices to
    ``out_size``."""
    n_even, n_odd = (out_size + 1) // 2, out_size // 2

    def fit(a, n):
        a = a.narrow(axis, 0, n)
        if n < n_even:
            shape = list(a.shape)
            shape[axis] = n_even - n
            a = torch.cat([a, a.new_zeros(shape)], dim=axis)
        return a

    woven = torch.stack([fit(even, n_even), fit(odd, n_odd)], dim=axis + 1)
    return woven.flatten(axis, axis + 1).narrow(axis, 0, out_size)


def _add_bias_last(out: torch.Tensor, b: Optional[torch.Tensor],
                   dtype: torch.dtype) -> torch.Tensor:
    """The fp32 conv sum ``out`` + bias over the last dim, in fp32, then
    one cast."""
    if b is None:
        return out.to(dtype)
    return (out.float() + b.float()).to(dtype)


def _parity_taps(lo: int, r: int) -> List[Optional[int]]:
    """Kernel tap of conv positions (a = 0 reads y[j - 1], a = 1 reads
    y[j]) for output parity ``r`` of a k=3 s=2 transpose with low pad
    ``lo``; None is a zero tap."""
    if lo == 0:
        return [2, 0] if r == 0 else [None, 1]
    return [None, 1] if r == 0 else [2, 0]


def shuffle_weights(w: torch.Tensor, out_spatial) -> torch.Tensor:
    """The k=2 conv kernel of a sub-pixel transpose: (3,)*nd + (c_out,
    c_in) TF weights -> (2,)*nd + (c_in, 2**nd * c_out) (HWIO / DHWIO),
    output channels (parities, c_out) with the parities in row-major
    order; conv position a = 0 reads y[j - 1], a = 1 reads y[j]
    (`_parity_taps`, by the parity of each output extent). Every entry is
    one weight or zero."""
    nd = w.dim() - 2
    los = [tf_same_padding(X, 3, 2)[0] for X in out_spatial]
    wz = torch.zeros_like(w[(0,) * nd])          # (c_out, c_in)
    parts = []
    for rs in np.ndindex(*(2,) * nd):
        taps = [_parity_taps(lo, r) for lo, r in zip(los, rs)]
        parts.append(torch.stack([
            wz if any(taps[i][a] is None for i, a in enumerate(pos))
            else w[tuple(taps[i][a] for i, a in enumerate(pos))]
            for pos in np.ndindex(*(2,) * nd)]))
    k = torch.stack(parts, dim=1)   # (positions, parities, c_out, c_in)
    c_out, c_in = w.shape[-2:]
    return k.permute(0, 3, 1, 2).reshape(*(2,) * nd, c_in,
                                         2 ** nd * c_out)


def _shuffle(y: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
             out_spatial) -> torch.Tensor:
    """`conv{2,3}d_transpose_shuffle` on channels-last ``y``."""
    nd = y.dim() - 2
    if current_sharding() is not None:
        raise NotImplementedError("the shuffle transpose does not run "
                                  "inside sharded_axis")
    if tuple(w.shape[:nd]) != (3,) * nd:
        raise ValueError(f"the shuffle transpose takes a k=3 kernel, got "
                         f"{tuple(w.shape)}")
    c_out = w.shape[-2]
    k2 = shuffle_weights(w.to(y.dtype), out_spatial)
    perm = (nd + 1, nd, *range(nd))                  # -> (O, I, *k)
    xc = y.permute(0, nd + 1, *range(1, nd + 1))     # channels first
    conv = _conv_sum(xc, k2.permute(*perm).float(), 1, 1)
    # (N, *(Y + 1), parities, c_out), the fp32 sums
    conv = conv.permute(0, *range(2, nd + 2), 1).reshape(
        *conv.shape[:1], *conv.shape[2:], 2 ** nd, c_out)
    los = [tf_same_padding(X, 3, 2)[0] for X in out_spatial]
    parts = {}
    for i, rs in enumerate(np.ndindex(*(2,) * nd)):
        t = conv[..., i, :]
        for axis, (r, lo) in enumerate(zip(rs, los)):
            # conv[m] = K0 y[m - 1] + K1 y[m]: parity j aligns with m = j,
            # but for lo = 1's odd parity (the w0 y[j + 1] term) m = j + 1
            if lo == 1 and r == 1:
                t = t.narrow(1 + axis, 1, t.shape[1 + axis] - 1)
        parts[rs] = t
    # weave the parities back, the last axis first
    for axis in reversed(range(nd)):
        merged = {}
        for rs, t in parts.items():
            merged.setdefault(rs[:axis], {})[rs[axis]] = t
        parts = {key: _weave_axis(v[0], v[1], 1 + axis, out_spatial[axis])
                 for key, v in merged.items()}
    return _add_bias_last(parts[()], b, y.dtype)


def conv2d_transpose_shuffle(y: torch.Tensor, w: torch.Tensor,
                             b: Optional[torch.Tensor] = None, *,
                             out_spatial) -> torch.Tensor:
    """TF conv2d_transpose (k=3, s=2, SAME) as one k=2 conv with 4x the
    output channels and a sub-pixel weave
    (`redtail_tpu/ops/convolution.py:conv2d_transpose_shuffle`): y NHWC,
    w (3, 3, c_out, c_in). Per axis, output 2j + r takes the kernel taps
    of `_parity_taps`; the four parities are the conv's output channels,
    each cropped by one where the low pad is 1 and the parity odd, then
    woven back. The conv is cuDNN's on fp32 carriers, the bias added
    after the weave in fp32 and the result rounded once. Exact."""
    return _shuffle(y, w, b, out_spatial)


def conv3d_transpose_shuffle(y: torch.Tensor, w: torch.Tensor,
                             b: Optional[torch.Tensor] = None, *,
                             out_spatial) -> torch.Tensor:
    """The 3D `conv2d_transpose_shuffle`: y NDHWC, w (3, 3, 3, c_out,
    c_in), one k=2 conv3d with 8x the output channels and three weaves
    (`redtail_tpu/ops/convolution.py:conv3d_transpose_shuffle`)."""
    return _shuffle(y, w, b, out_spatial)


DfoldBlock = Tuple[int, int, int, int, torch.Tensor]


def dfold_weights(w: torch.Tensor, *, out_spatial, d_in: int,
                  h_packed: bool = False,
                  d_block: Optional[int] = None) -> List[DfoldBlock]:
    """The banded k=2 conv2d weights of `conv3d_transpose_dfold`, one per
    block of output depths: (i_lo, i_hi, ob, ob_hi, OIHW weight) with input
    depths i_lo..i_hi feeding output depths ob..ob_hi - 1. Depends on the
    parities of ``out_spatial``; the model derives them once, at load.

    w: (3, 3, 3, c_out, c_in) (TF VRSCK); ``d_in``: the true input depth
    (twice the slots of a D-packed input)."""
    c_out, c_in = w.shape[3], w.shape[4]
    d_out = out_spatial[0]
    lo_d, lo_h, lo_w = [tf_same_padding(X, 3, 2)[0] for X in out_spatial]
    wf = w.float()
    wz = torch.zeros_like(wf[0, 0, 0])  # (c_out, c_in)
    rows = []
    for a_h in (0, 1):
        for a_w in (0, 1):
            for rh in (0, 1):
                for rw in (0, 1):
                    th = _parity_taps(lo_h, rh)[a_h]
                    tw = _parity_taps(lo_w, rw)[a_w]
                    for td in range(3):
                        rows.append(wz if th is None or tw is None
                                    else wf[td, th, tw])
    wh = torch.stack(rows).reshape(2, 2, 2, 2, 3, c_out, c_in)
    if h_packed:
        # the H window re-expression a_h = 2*a_s + qh - pp moves the
        # conv-position parity pp into output channels (out of range: 0)
        prow = [wh[2 * a_s + qh - pp] if 0 <= 2 * a_s + qh - pp <= 1
                else torch.zeros_like(wh[0])
                for a_s in (0, 1) for qh in (0, 1) for pp in (0, 1)]
        wh = torch.stack(prow).reshape(2, 2, 2, *wh.shape[1:])
    blk = d_block or (16 if h_packed else (32 if d_out > 48 else d_out))
    blocks = []
    for ob in range(0, d_out, blk):
        ob_hi = min(ob + blk, d_out)
        i_lo = max(0, (ob + lo_d - 2) // 2)
        i_hi = min(d_in - 1, (ob_hi - 1 + lo_d) // 2)
        t_idx = np.arange(3)[:, None, None]
        i_idx = np.arange(i_lo, i_hi + 1)[None, :, None]
        o_idx = np.arange(ob, ob_hi)[None, None, :]
        band = torch.from_numpy(
            (o_idx == 2 * i_idx - lo_d + t_idx).astype(np.float32))
        if h_packed:
            k2 = torch.einsum("tio,xqpyrstck->xyqikprsoc", band, wh)
            k2 = k2.reshape(2, 2, 2 * (i_hi + 1 - i_lo) * c_in,
                            8 * (ob_hi - ob) * c_out)
        else:
            k2 = torch.einsum("tio,xyrstck->xyikrsoc", band, wh)
            k2 = k2.reshape(2, 2, (i_hi + 1 - i_lo) * c_in,
                            4 * (ob_hi - ob) * c_out)
        weight = k2.permute(3, 2, 0, 1).to(w.dtype).contiguous(
            memory_format=torch.channels_last)
        blocks.append((i_lo, i_hi, ob, ob_hi, weight))
    return blocks


def conv3d_transpose_dfold(y: torch.Tensor, w: Optional[torch.Tensor],
                           b: Optional[torch.Tensor] = None, *,
                           out_spatial, d_packed: bool = False,
                           h_packed: bool = False, layout: str = "ndhwc",
                           d_block: Optional[int] = None,
                           reduce: Optional[Callable] = None,
                           blocks: Optional[List[DfoldBlock]] = None
                           ) -> torch.Tensor:
    """TF conv3d_transpose (k=3, s=2, SAME) with the D axis folded into
    channels (`redtail_tpu/ops/convolution.py:conv3d_transpose_dfold`): per
    block of output depths, ONE k=2 conv2d (pad (1, 1)) whose output
    channels enumerate (H-parity, W-parity, d_out, c_out) and whose input
    channels are (d_in, c_in), with the D deposit relation o = 2i - lo + t
    baked into banded weights (`dfold_weights`, or ``blocks`` derived
    once). Exact.

    y: NDHWC, or with ``d_packed`` the packed3d (pd, c) D-packed layout,
    or with ``h_packed`` too the full 'dh' layout (N, Dp, Hp, W, (qh, qd,
    c)). ``layout='dlast'`` emits (N, H, W, D, c_out). ``d_block``: the
    output-depth block (default 16 when H-packed, else 32 for D_out > 48,
    else unsplit). ``reduce``: a per-pixel reduction over the trailing
    (D, c_out) dims (the models' soft-argmin), applied to each parity map
    before the full-resolution weaves, after the bias and the cast;
    requires 'dlast' and returns (N, H_out, W_out).

    Inside an image `sharded_axis` each rank returns its own output rows
    (the ownership rule over H_out) from the input slots they read,
    fetched by one `exchange`: the D-folded conv runs on that slab as on a
    whole input of the same H parity, and its rows are cropped."""
    if h_packed and not d_packed:
        raise ValueError("h_packed input implies the 'dh' packed layout")
    if layout not in ("ndhwc", "dlast"):
        raise ValueError(f"unknown layout {layout!r}")
    if reduce is not None and layout != "dlast":
        raise ValueError("reduce= requires layout='dlast'")
    kw = dict(d_packed=d_packed, h_packed=h_packed, layout=layout,
              d_block=d_block, reduce=reduce, blocks=blocks)
    sh = image_sharding()
    if sh is None:
        return _dfold(y, w, b, out_spatial=out_spatial, **kw)
    d_out, h_out, w_out = out_spatial
    lo = tf_same_padding(h_out, 3, 2)[0]
    per = 2 if h_packed else 1      # input rows a slot of axis 2 holds
    h_in = -(-h_out // 2)

    def need(a, b_):
        # the transposed conv's window (output row o reads input rows i
        # with o = 2 i - lo + t, t in [0, 3)), cut to the axis, in slots
        i0, i1 = window_rows(a, b_, k=3, lo=2 - lo, dil=2)
        return max(i0, 0) // per, -(-min(i1, h_in) // per)

    y, (a, b_), (s0, s1) = fetch(y, sh, 2, global_size=-(-h_in // per),
                                 out_size=h_out, need=need)
    if b_ == a:
        if blocks is None:
            c_out = w.shape[3]
        else:   # a block's output channels: (parities, depths, c_out)
            _, _, ob, ob_hi, weight = blocks[0]
            c_out = weight.shape[0] // (4 * per * (ob_hi - ob))
        shape = ((y.shape[0], d_out, 0, w_out, c_out) if layout == "ndhwc"
                 else (y.shape[0], 0, w_out) if reduce is not None
                 else (y.shape[0], 0, w_out, d_out, c_out))
        return empty_shard(y, shape, y.dtype)
    n_in = per * (s1 - s0)
    out = _dfold(y, w, b, out_spatial=(d_out, 2 * n_in - h_out % 2, w_out),
                 **kw)
    # local output row 0 is global row 2 * per * s0
    return out.narrow(2 if layout == "ndhwc" else 1, a - 2 * per * s0,
                      b_ - a)


def _dfold(y: torch.Tensor, w: Optional[torch.Tensor],
           b: Optional[torch.Tensor], *, out_spatial, d_packed: bool,
           h_packed: bool, layout: str, d_block: Optional[int],
           reduce: Optional[Callable], blocks: Optional[List[DfoldBlock]]
           ) -> torch.Tensor:
    """`conv3d_transpose_dfold` on a whole input."""
    d_out_n, h_out, w_out = out_spatial
    if h_packed:
        n, dp_n, hs_n, w_in, c4 = y.shape
        c_in, d_in_n = c4 // 4, 2 * dp_n
        h_in = -(-h_out // 2)
        # each row-parity half to (N, Hs, W, d-major (d, c)) channels: the
        # packed (d2, pd, c) order is exactly the true-depth order
        halves = [y[..., qh * 2 * c_in:(qh + 1) * 2 * c_in]
                  .permute(0, 2, 3, 1, 4).reshape(n, hs_n, w_in,
                                                  d_in_n * c_in)
                  for qh in (0, 1)]
    else:
        n, d_in_n, h_in, w_in, c_in = y.shape
        if d_packed:
            d_in_n, c_in = 2 * d_in_n, c_in // 2
        y2 = y.permute(0, 2, 3, 1, 4).reshape(n, h_in, w_in, d_in_n * c_in)
    if blocks is None:
        if w.shape[:3] != (3, 3, 3):
            raise ValueError("dfold takes a k=3 kernel")
        blocks = dfold_weights(w.to(y.dtype), out_spatial=out_spatial,
                               d_in=d_in_n, h_packed=h_packed,
                               d_block=d_block)
    pgroups = 8 if h_packed else 4
    parts = []
    for i_lo, i_hi, ob, ob_hi, weight in blocks:
        if h_packed:
            x_win = torch.cat([hf[..., i_lo * c_in:(i_hi + 1) * c_in]
                               for hf in halves], dim=-1)
        else:
            x_win = y2[..., i_lo * c_in:(i_hi + 1) * c_in]
        xc = x_win.permute(0, 3, 1, 2)
        with _fp32_accumulate(xc):
            part = F.conv2d(xc.float(), weight.float(),
                            padding=1).permute(0, 2, 3, 1)
        parts.append(part.reshape(n, part.shape[1], w_in + 1, pgroups,
                                  ob_hi - ob, -1))
    conv = torch.cat(parts, dim=4) if len(parts) > 1 else parts[0]
    c_out = conv.shape[-1]
    rest = (d_out_n, c_out)
    if reduce is not None:
        # the weaves below are pure spatial interleaves/slices, so a
        # per-pixel consumer commutes with them: reduce each parity map
        # first and weave the (N, H, W) maps
        conv = reduce(_add_bias_last(conv, b, y.dtype))
        rest = ()
    lo_h, lo_w = (tf_same_padding(X, 3, 2)[0] for X in out_spatial[1:])
    if h_packed:
        conv = conv.reshape(n, hs_n + 1, w_in + 1, 2, 2, 2, *rest)
        # recover the conv-position axis p = 2*ps + pp - 1: one weave
        conv = _weave_axis(conv[:, :, :, 1], conv[:, 1:, :, 0], 1, h_in + 1)
    conv = conv.reshape(n, h_in + 1, w_in + 1, 2, 2, *rest)
    outs = {}
    for rh in (0, 1):
        for rw in (0, 1):
            off_h = 1 if (lo_h == 1 and rh == 1) else 0
            off_w = 1 if (lo_w == 1 and rw == 1) else 0
            outs[(rh, rw)] = conv[:, off_h:, off_w:, rh, rw]
    g = [_weave_axis(outs[(rh, 0)], outs[(rh, 1)], 2, w_out)
         for rh in (0, 1)]
    out = _weave_axis(g[0], g[1], 1, h_out)  # (N, Hout, Wout[, Dout, c])
    if reduce is not None:
        return out
    out = _add_bias_last(out, b, y.dtype)
    if layout == "dlast":
        return out
    return out.permute(0, 3, 1, 2, 4)
