"""The dense (2, 2, 3) conv of the packed 3D head: the hand-written CUDA
kernel, its plain PyTorch version and the wrapper that chooses between them
by device.

    out[n, d, h, x, :] = b + sum over td, th in {0, 1}, tw in {0, 1, 2} of
                         xp[n, d + td, h + th, x + tw - 1, :] @ k[td, th, tw]

with xp zero outside [0, W) along x: xp (N, Dp, Hp, W, C) x k (2, 2, 3, C,
K) -> (N, Dp - 1, Hp - 1, W, K) in xp's dtype, accumulated in fp32, the
(K,) bias added in the accumulator and the sum rounded once. It is the
stride-1 conv of `ops/packed3d.py:conv3d_packed` in its in-shifted,
H-packed form (the packed head's conv3D_2 / conv3D_1b) and replaces the TPU
kernel `redtail_tpu/kernels/conv223_pallas.py:60` (`_conv223_kernel`); the
design notes are in `redtail_tpu_torch/csrc/conv223.cu`.

The wrapper runs the plain version only for tensors on the CPU. For CUDA
tensors it launches the kernel or raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from redtail_tpu_torch.kernels import _build

DTYPES = (torch.float32, torch.bfloat16)
MAX_C = 256  # the fp32 kernel stages a whole (4, 34, C) window


def conv223_plain(xp: torch.Tensor, k: torch.Tensor,
                  bias: Optional[torch.Tensor]) -> torch.Tensor:
    """Plain PyTorch version: the 12 per-tap products summed in fp32, the
    bias added, one cast."""
    n, dp, hp, w, c = xp.shape
    xf = F.pad(xp.float(), (0, 0, 1, 1))       # zero column either side of W
    kf = k.float()
    acc = xf.new_zeros((n, dp - 1, hp - 1, w, k.shape[-1]))
    for td in range(2):
        for th in range(2):
            for tw in range(3):
                acc += (xf[:, td:td + dp - 1, th:th + hp - 1, tw:tw + w]
                        @ kf[td, th, tw])
    if bias is not None:
        acc += bias.float()
    return acc.to(xp.dtype)


def _check(xp, k, bias):
    if xp.dim() != 5 or k.dim() != 5 or tuple(k.shape[:3]) != (2, 2, 3) \
            or k.shape[3] != xp.shape[-1]:
        raise ValueError("xp must be (N, Dp, Hp, W, C) and k (2, 2, 3, C, K); "
                         f"got {tuple(xp.shape)} and {tuple(k.shape)}")
    if xp.dtype not in DTYPES or k.dtype != xp.dtype:
        raise TypeError("xp and k must both be float32 or bfloat16; got "
                        f"{xp.dtype} and {k.dtype}")
    if min(xp.shape) < 1 or xp.shape[1] < 2 or xp.shape[2] < 2:
        raise ValueError(f"empty output: xp {tuple(xp.shape)} needs Dp >= 2 "
                         "and Hp >= 2")
    if bias is not None and tuple(bias.shape) != (k.shape[-1],):
        raise ValueError(f"bias must be ({k.shape[-1]},); got "
                         f"{tuple(bias.shape)}")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("conv223")
    lib.conv223_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    lib.conv223_launch.restype = ctypes.c_int
    lib.conv223_error_string.argtypes = [ctypes.c_int]
    lib.conv223_error_string.restype = ctypes.c_char_p
    return lib


def conv223(xp: torch.Tensor, k: torch.Tensor,
            bias: Optional[torch.Tensor]) -> torch.Tensor:
    """(N, Dp, Hp, W, C) x (2, 2, 3, C, K) [+ (K,) bias] -> (N, Dp - 1,
    Hp - 1, W, K) (see the module docstring).

    CPU tensors take `conv223_plain`. CUDA tensors launch the kernel on the
    current stream and add one to ``conv223.launches``; they must be
    contiguous, on one device, with C and K multiples of 16 and
    C <= 256."""
    _check(xp, k, bias)
    tensors = (xp, k) if bias is None else (xp, k, bias)
    if all(t.device.type == "cpu" for t in tensors):
        return conv223_plain(xp, k, bias)
    if not (xp.is_cuda and all(t.device == xp.device for t in tensors)):
        raise ValueError("xp, k and bias must lie on one CUDA device (or all "
                         f"on the CPU); got {[str(t.device) for t in tensors]}")
    if not (xp.is_contiguous() and k.is_contiguous()):
        raise ValueError("the CUDA kernel takes contiguous xp (N, Dp, Hp, W, "
                         "C) and k (2, 2, 3, C, K)")
    n, dp, hp, w, c = xp.shape
    kk = k.shape[-1]
    if c % 16 or kk % 16 or c > MAX_C:
        raise ValueError(f"the CUDA kernel takes C and K multiples of 16 and "
                         f"C <= {MAX_C} (the packed head's 64 or 128); got "
                         f"C={c}, K={kk}")
    if n * (dp - 1) > 65535 or hp > 65535:
        raise ValueError(f"N * (Dp - 1) and Hp must be <= 65535 (grid "
                         f"limit); got {n * (dp - 1)}, {hp}")
    b = (torch.zeros(kk, device=xp.device) if bias is None
         else bias.float().contiguous())
    out = torch.empty((n, dp - 1, hp - 1, w, kk), dtype=xp.dtype,
                      device=xp.device)
    for t in (xp, k, out):
        if t.data_ptr() % 32:
            raise ValueError("tensor storage not aligned to 32 bytes")
    lib = _lib()
    err = lib.conv223_launch(
        xp.data_ptr(), k.data_ptr(), b.data_ptr(), out.data_ptr(), n, dp, hp,
        w, c, kk, int(xp.dtype == torch.bfloat16), xp.device.index,
        torch.cuda.current_stream(xp.device).cuda_stream)
    if err:
        raise RuntimeError(
            f"conv223 kernel launch failed: CUDA error {err} "
            f"({lib.conv223_error_string(err).decode()})")
    conv223.launches += 1
    return out


conv223.launches = 0
