"""Concat cost volume: the hand-written CUDA kernel, its plain PyTorch
version and the wrapper that chooses between them by device.

    out[n, d, h, x, 0:C]  = L[n, h, x, :]
    out[n, d, h, x, C:2C] = R[n, h, x - d, :],  zero where x < d

(N, H, W, C) x2 -> (N, D, H, W, 2C) in the input dtype: the layout of the
JAX package's `ops/cost_volume.py:cost_volume` and of the Pallas entry
`cost_volume_pallas`. It replaces the TPU kernel
`redtail_tpu/kernels/cost_volume_pallas.py:158` (`_concat_kernel`); the
design notes are in `redtail_tpu_torch/csrc/cost_volume_concat.cu`. A pure
copy: kernel and plain version agree bit for bit.

The wrapper runs the plain version only for tensors on the CPU. For CUDA
tensors it launches the kernel or raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from redtail_tpu_torch.kernels import _build

DTYPES = (torch.float32, torch.bfloat16)


def cost_volume_concat_plain(left: torch.Tensor, right: torch.Tensor,
                             max_disp: int) -> torch.Tensor:
    """Plain PyTorch version: one shifted copy per disparity."""
    n, h, w, c = left.shape
    out = left.new_zeros((n, max_disp, h, w, 2 * c))
    out[..., :c] = left.unsqueeze(1)
    for d in range(min(max_disp, w)):
        out[:, d, :, d:, c:] = right[:, :, :w - d]
    return out


def _check(left, right, max_disp):
    if left.dim() != 4 or left.shape != right.shape:
        raise ValueError("left and right must be NHWC tensors of one shape; "
                         f"got {tuple(left.shape)} and {tuple(right.shape)}")
    if left.dtype not in DTYPES or right.dtype != left.dtype:
        raise TypeError("left and right must both be float32 or bfloat16; "
                        f"got {left.dtype} and {right.dtype}")
    if min(left.shape) < 1:
        raise ValueError(f"empty input {tuple(left.shape)}")
    if int(max_disp) != max_disp or max_disp < 1:
        raise ValueError(f"max_disp must be an integer >= 1, got {max_disp}")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("cost_volume_concat")
    lib.cost_volume_concat_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.cost_volume_concat_launch.restype = ctypes.c_int
    lib.cost_volume_concat_error_string.argtypes = [ctypes.c_int]
    lib.cost_volume_concat_error_string.restype = ctypes.c_char_p
    return lib


def cost_volume_concat(left: torch.Tensor, right: torch.Tensor,
                       max_disp: int) -> torch.Tensor:
    """NHWC pair -> (N, D, H, W, 2C) concat volume (see the module
    docstring).

    CPU tensors take `cost_volume_concat_plain`. CUDA tensors launch the
    kernel on the current stream and add one to
    ``cost_volume_concat.launches``; they must be contiguous NHWC on one
    device."""
    _check(left, right, max_disp)
    if left.device.type == "cpu" and right.device.type == "cpu":
        return cost_volume_concat_plain(left, right, max_disp)
    if not (left.is_cuda and right.device == left.device):
        raise ValueError("left and right must lie on one CUDA device (or "
                         f"both on the CPU); got {left.device} and "
                         f"{right.device}")
    if not (left.is_contiguous() and right.is_contiguous()):
        raise ValueError("the CUDA kernel takes contiguous NHWC tensors")
    n, h, w, c = left.shape
    if n > 65535 or h > 65535:
        raise ValueError(f"N and H must be <= 65535 (grid limit); got {n}, {h}")
    pixel_bytes = c * left.element_size()
    # the widest copy word that divides a pixel (pointers are 256-aligned
    # by the allocator, rows then stay aligned to the word)
    word = next(v for v in (16, 8, 4, 2) if pixel_bytes % v == 0)
    out = torch.empty((n, max_disp, h, w, 2 * c), dtype=left.dtype,
                      device=left.device)
    for t in (left, right, out):
        if t.data_ptr() % word:
            raise ValueError(f"tensor storage not aligned to {word} bytes")
    lib = _lib()
    err = lib.cost_volume_concat_launch(
        left.data_ptr(), right.data_ptr(), out.data_ptr(), n, h, w,
        pixel_bytes, int(max_disp), word, left.device.index,
        torch.cuda.current_stream(left.device).cuda_stream)
    if err:
        raise RuntimeError(
            f"cost_volume_concat kernel launch failed: CUDA error {err} "
            f"({lib.cost_volume_concat_error_string(err).decode()})")
    cost_volume_concat.launches += 1
    return out


cost_volume_concat.launches = 0
