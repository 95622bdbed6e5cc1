"""Correlation cost volume: the hand-written CUDA kernel, its plain PyTorch
version and the wrapper that chooses between them by device.

    out[n, h, x, d] = sum_c L[n, h, x, c] * R[n, h, x - d, c],  zero where x < d

accumulated in fp32. It replaces the TPU kernel
`redtail_tpu/kernels/cost_volume_pallas.py:43` (`_corr_kernel`); the design
notes are in `redtail_tpu_torch/csrc/corr_cost_volume.cu`. Two layouts:

- ``layout="dlast"``: (N, H, W, D) in fp32, what the ResNet18-2D model
  consumes (the JAX model's `ops/cost_volume.py:corr_cost_volume_dlast`);
- ``layout="hdw"``: (N, H, D, W) in the input dtype, the Pallas kernel's
  contract (`corr_cost_volume_pallas`).

The wrapper runs the plain version only for tensors on the CPU. For CUDA
tensors it launches the kernel or raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from redtail_tpu_torch.kernels import _build

LAYOUTS = ("dlast", "hdw")
DTYPES = (torch.float32, torch.bfloat16)


def corr_cost_volume_plain(left: torch.Tensor, right: torch.Tensor,
                           max_disp: int, *, layout: str = "dlast"
                           ) -> torch.Tensor:
    """Plain PyTorch version: one shifted product-sum per disparity."""
    n, h, w, _ = left.shape
    lf, rf = left.float(), right.float()
    out = lf.new_zeros((n, h, w, max_disp))
    for d in range(min(max_disp, w)):
        out[:, :, d:, d] = (lf[:, :, d:] * rf[:, :, :w - d]).sum(-1)
    if layout == "hdw":
        return out.permute(0, 1, 3, 2).contiguous().to(left.dtype)
    return out


def _check(left, right, max_disp, layout):
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
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
    lib = _build.load("corr_cost_volume")
    lib.corr_cost_volume_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    lib.corr_cost_volume_launch.restype = ctypes.c_int
    lib.corr_cost_volume_error_string.argtypes = [ctypes.c_int]
    lib.corr_cost_volume_error_string.restype = ctypes.c_char_p
    return lib


def corr_cost_volume(left: torch.Tensor, right: torch.Tensor, max_disp: int,
                     *, layout: str = "dlast") -> torch.Tensor:
    """NHWC pair -> correlation volume (see the module docstring).

    CPU tensors take `corr_cost_volume_plain`. CUDA tensors launch the
    kernel on the current stream and add one to ``corr_cost_volume.launches``;
    they must be contiguous NHWC on one device."""
    _check(left, right, max_disp, layout)
    if left.device.type == "cpu" and right.device.type == "cpu":
        return corr_cost_volume_plain(left, right, max_disp, layout=layout)
    if not (left.is_cuda and right.device == left.device):
        raise ValueError("left and right must lie on one CUDA device (or "
                         f"both on the CPU); got {left.device} and "
                         f"{right.device}")
    if not (left.is_contiguous() and right.is_contiguous()):
        raise ValueError("the CUDA kernel takes contiguous NHWC tensors")
    n, h, w, c = left.shape
    if n > 65535 or h > 65535:
        raise ValueError(f"N and H must be <= 65535 (grid limit); got {n}, {h}")
    dlast = layout == "dlast"
    out = torch.empty((n, h, w, max_disp) if dlast else (n, h, max_disp, w),
                      dtype=torch.float32 if dlast else left.dtype,
                      device=left.device)
    lib = _lib()
    err = lib.corr_cost_volume_launch(
        left.data_ptr(), right.data_ptr(), out.data_ptr(), n, h, w, c,
        int(max_disp), int(left.dtype == torch.bfloat16), int(dlast),
        left.device.index, torch.cuda.current_stream(left.device).cuda_stream)
    if err:
        raise RuntimeError(
            f"corr_cost_volume kernel launch failed: CUDA error {err} "
            f"({lib.corr_cost_volume_error_string(err).decode()})")
    corr_cost_volume.launches += 1
    return out


corr_cost_volume.launches = 0
