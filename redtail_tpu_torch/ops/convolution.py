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
- the bias is added in fp32 before the cast to the input dtype. cuDNN
  returns a bf16 conv output already rounded, so on the bf16 path the sum
  is rounded twice where JAX rounds once;
- fp32 convolutions run in full fp32, as JAX's ``Precision.HIGHEST``:
  cuDNN would otherwise use TF32, so `_exact_fp32` turns TF32 off (cuDNN
  and matmul flags) around each fp32 CUDA conv and restores it after.

`plain_lowering` is the JAX package's switch to the spec-literal forms; in
the port it selects the explicit concat volume + dense conv3D_1 over the
fused cost volume + conv3D_1 (`models/stereo.py`).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

Strides = Union[int, Sequence[int]]

_PLAIN_LOWERING = contextvars.ContextVar("redtail_torch_plain_lowering",
                                         default=False)


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


def tf_same_padding(in_dim: int, kern_dim: int,
                    stride_dim: int) -> Tuple[int, int]:
    """TF ``SAME`` padding (lo, hi) for one dim."""
    if in_dim % stride_dim == 0:
        pad_along = max(kern_dim - stride_dim, 0)
    else:
        pad_along = max(kern_dim - (in_dim % stride_dim), 0)
    pad_start = pad_along // 2
    return pad_start, pad_along - pad_start


@contextlib.contextmanager
def _exact_fp32(x: torch.Tensor):
    if not (x.is_cuda and x.dtype == torch.float32):
        yield
        return
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def _add_bias(out: torch.Tensor, b: Optional[torch.Tensor],
              dtype: torch.dtype) -> torch.Tensor:
    if b is None:
        return out.to(dtype)
    return (out.float() + b.float().reshape(-1, *[1] * (out.dim() - 2))
            ).to(dtype)


_CONV = {4: F.conv2d, 5: F.conv3d}
_CONV_T = {4: F.conv_transpose2d, 5: F.conv_transpose3d}


def _tuple(strides: Strides, n: int) -> Tuple[int, ...]:
    return (int(strides),) * n if isinstance(strides, int) else tuple(strides)


def _padding(padding: str) -> str:
    if padding.upper() not in ("SAME", "VALID"):
        raise ValueError(f"unknown padding {padding!r}")
    return padding.upper()


def _conv(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
          strides: Strides, padding: str) -> torch.Tensor:
    """TF conv over channels-first x (N, C, *S) with w (O, I, *k)."""
    padding = _padding(padding)
    strides = _tuple(strides, x.dim() - 2)
    pads = [tf_same_padding(i, k, s) if padding == "SAME" else (0, 0)
            for i, k, s in zip(x.shape[2:], w.shape[2:], strides)]
    if all(lo == hi for lo, hi in pads):
        conv_pad = tuple(lo for lo, _ in pads)
    else:
        x = F.pad(x, [p for pair in reversed(pads) for p in pair])
        conv_pad = 0
    with _exact_fp32(x):
        out = _CONV[x.dim()](x, w, stride=strides, padding=conv_pad)
    return _add_bias(out, b, x.dtype)


def _conv_transpose(y: torch.Tensor, w: torch.Tensor,
                    b: Optional[torch.Tensor], out_spatial: Sequence[int],
                    strides: Strides, padding: str) -> torch.Tensor:
    """TF ``conv{2,3}d_transpose``: the gradient of the forward conv that
    maps ``out_spatial`` to y's size. y (N, K, *Y), w (K, C, *k)."""
    padding = _padding(padding)
    strides = _tuple(strides, y.dim() - 2)
    with _exact_fp32(y):
        full = _CONV_T[y.dim()](y, w, stride=strides)
    crop = []
    for size, full_size, k, s in zip(out_spatial, full.shape[2:],
                                     w.shape[2:], strides):
        lo = tf_same_padding(size, k, s)[0] if padding == "SAME" else 0
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


def conv2d_transpose(y: torch.Tensor, w: torch.Tensor,
                     b: Optional[torch.Tensor] = None, *,
                     out_spatial: Sequence[int],
                     strides: Tuple[int, int] = (2, 2)) -> torch.Tensor:
    """TF ``conv2d_transpose``: NHWC activations, HWIO weights with
    I = output channels of the transpose and O = its input channels."""
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
                     padding: str = "SAME") -> torch.Tensor:
    """TF ``conv3d_transpose``: NDHWC activations, DHWIO weights with
    I = output channels of the transpose and O = its input channels."""
    out = conv3d_transpose_ncdhw(
        y.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2), b,
        out_spatial=out_spatial, stride=tuple(strides), padding=padding)
    return out.permute(0, 2, 3, 4, 1)
