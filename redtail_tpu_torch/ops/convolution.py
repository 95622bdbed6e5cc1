"""TF-semantics 2D convolution and transposed convolution
(`redtail_tpu/ops/convolution.py`).

The public functions keep the JAX package's layouts: NHWC activations and
HWIO weights (for the transpose, I = its output channels, as TF stores
them). The model calls the `*_nchw` forms on NCHW tensors in
`torch.channels_last` memory (which is NHWC in memory, so no copies) with
weights moved to PyTorch's layout once at load.

The convolutions themselves are cuDNN's (on the CPU, PyTorch's), as the JAX
package leaves them to XLA. What is TF's is arranged around them:

- TF-SAME padding is asymmetric for stride 2, so the input is padded
  explicitly and the conv runs with ``padding=0``;
- the transposed conv is cropped to ``out_spatial`` at the forward conv's
  low pad;
- the bias is added in fp32 before the cast to the input dtype. cuDNN
  returns a bf16 conv output already rounded, so on the bf16 path the sum
  is rounded twice where JAX rounds once;
- fp32 convolutions run in full fp32, as JAX's ``Precision.HIGHEST``:
  cuDNN would otherwise use TF32, so `_exact_fp32` turns TF32 off (cuDNN
  and matmul flags) around each fp32 CUDA conv and restores it after.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F


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
    return (out.float() + b.float().reshape(1, -1, 1, 1)).to(dtype)


def conv2d_nchw(x: torch.Tensor, w: torch.Tensor,
                b: Optional[torch.Tensor] = None,
                stride: int = 1) -> torch.Tensor:
    """TF-SAME conv: x (N, C, H, W), w (O, I, kh, kw) -> (N, O, H', W')."""
    (ph0, ph1), (pw0, pw1) = (
        tf_same_padding(x.shape[2], w.shape[2], stride),
        tf_same_padding(x.shape[3], w.shape[3], stride))
    xp = F.pad(x, (pw0, pw1, ph0, ph1))  # last dim first
    with _exact_fp32(x):
        out = F.conv2d(xp, w, stride=stride)
    return _add_bias(out, b, x.dtype)


def conv2d_transpose_nchw(y: torch.Tensor, w: torch.Tensor,
                          b: Optional[torch.Tensor] = None, *,
                          out_spatial: Sequence[int],
                          stride: int = 2) -> torch.Tensor:
    """TF ``conv2d_transpose`` (SAME): the gradient of the forward conv that
    maps ``out_spatial`` to y's size. y (N, K, Y, X), w (K, C, kh, kw) ->
    (N, C, *out_spatial)."""
    with _exact_fp32(y):
        full = F.conv_transpose2d(y, w, stride=stride)
    crop = []
    for size, full_size, k in zip(out_spatial, full.shape[2:], w.shape[2:]):
        lo = tf_same_padding(size, k, stride)[0]
        if lo + size > full_size:
            raise ValueError(f"out_spatial {tuple(out_spatial)} is not a "
                             f"TF-SAME output for input {tuple(y.shape[2:])}")
        crop.append(slice(lo, lo + size))
    return _add_bias(full[:, :, crop[0], crop[1]], b, y.dtype)


def conv2d(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None, *,
           strides: Tuple[int, int] = (1, 1)) -> torch.Tensor:
    """2D convolution, NHWC activations, HWIO weights, TF ``SAME``."""
    if strides[0] != strides[1]:
        raise ValueError(f"square strides only, got {strides}")
    out = conv2d_nchw(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), b,
                      strides[0])
    return out.permute(0, 2, 3, 1)


def conv2d_transpose(y: torch.Tensor, w: torch.Tensor,
                     b: Optional[torch.Tensor] = None, *,
                     out_spatial: Sequence[int],
                     strides: Tuple[int, int] = (2, 2)) -> torch.Tensor:
    """TF ``conv2d_transpose``: NHWC activations, HWIO weights with
    I = output channels of the transpose and O = its input channels."""
    if strides[0] != strides[1]:
        raise ValueError(f"square strides only, got {strides}")
    out = conv2d_transpose_nchw(y.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                                b, out_spatial=out_spatial,
                                stride=strides[0])
    return out.permute(0, 2, 3, 1)
