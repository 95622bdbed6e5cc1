"""Fused cost volume + conv3D_1, per-disparity assembly: the hand-written
CUDA kernel, its plain PyTorch version and the wrapper that chooses between
them by device.

From the six 2D conv maps of `ops/fused_cost_volume_conv.py`

    la (N, H, W, 3K) = [a0 | a1 | a2],  rb (N, H, W, 6K) = [bk0 | bk1 | bk2 | cc0 | cc1 | cc2]

it assembles conv3D_1's output over the concat cost volume,
(N, D, H, W, K) in the maps' dtype, with the bias and (``elu=True``) the
ELU fused, accumulated in fp32 and rounded once. It replaces the TPU kernel
`redtail_tpu/kernels/fused_cv_emit_pallas.py:65` (`_emit_kernel`) in the
unpacked layout; the formula and the design notes are in
`redtail_tpu_torch/csrc/fused_cv_emit.cu`.

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


def fused_cv_emit_plain(la: torch.Tensor, rb: torch.Tensor,
                        bias: Optional[torch.Tensor], max_disp: int, *,
                        elu: bool = True) -> torch.Tensor:
    """Plain PyTorch version: `d_slices` of the JAX package
    (`ops/fused_cost_volume_conv.py:121-174`) in fp32, rounded once."""
    n, h, w, k3 = la.shape
    k = k3 // 3
    lf, rf = la.float(), rb.float()
    a = [lf[..., i * k:(i + 1) * k] for i in range(3)]
    bk = [rf[..., i * k:(i + 1) * k] for i in range(3)]
    cc = [rf[..., (3 + i) * k:(4 + i) * k] for i in range(3)]
    s0 = F.pad(bk[0][:, :, 1:], (0, 0, 0, 1))    # s0[x] = bk0[x + 1]
    s2 = F.pad(bk[2][:, :, :-1], (0, 0, 1, 0))   # s2[x] = bk2[x - 1]
    s_map = s0 + bk[1] + s2
    a_sum = a[0] + a[1] + a[2]

    def shift_w(m, d):
        out = torch.zeros_like(m)
        if d < w:
            out[:, :, d:] = m[:, :, :w - d]
        return out

    out = lf.new_empty((n, max_disp, h, w, k))
    for d in range(max_disp):
        acc = a_sum + shift_w(s_map, d)
        if d == 0:             # depth tap d - 1 out of range
            acc = acc - a[0] - s0
        if d == max_disp - 1:  # depth tap d + 1 out of range
            acc = acc - a[2] - shift_w(s2, d)
        if 1 <= d <= w:        # composition fix-up of tap 0
            acc[:, :, d - 1] += bk[0][:, :, 0]
        for i in range(3):
            dp = d + i - 1
            if 1 <= dp <= max_disp - 1 and dp < w:
                acc[:, :, dp - 1] += cc[i][:, :, 0]
                acc[:, :, w - 1] -= cc[i][:, :, w - dp]
        if bias is not None:
            acc = acc + bias.float()
        out[:, d] = F.elu(acc) if elu else acc
    return out.to(la.dtype)


def _check(la, rb, bias, max_disp):
    if la.dim() != 4 or rb.dim() != 4 or la.shape[-1] % 3 \
            or la.shape[:3] != rb.shape[:3] \
            or rb.shape[-1] != 2 * la.shape[-1]:
        raise ValueError("la must be (N, H, W, 3K) and rb (N, H, W, 6K); got "
                         f"{tuple(la.shape)} and {tuple(rb.shape)}")
    if la.dtype not in DTYPES or rb.dtype != la.dtype:
        raise TypeError("la and rb must both be float32 or bfloat16; got "
                        f"{la.dtype} and {rb.dtype}")
    if min(la.shape) < 1:
        raise ValueError(f"empty input {tuple(la.shape)}")
    if bias is not None and tuple(bias.shape) != (la.shape[-1] // 3,):
        raise ValueError(f"bias must be ({la.shape[-1] // 3},); got "
                         f"{tuple(bias.shape)}")
    if int(max_disp) != max_disp or max_disp < 1:
        raise ValueError(f"max_disp must be an integer >= 1, got {max_disp}")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_cv_emit")
    lib.fused_cv_emit_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    lib.fused_cv_emit_launch.restype = ctypes.c_int
    lib.fused_cv_emit_error_string.argtypes = [ctypes.c_int]
    lib.fused_cv_emit_error_string.restype = ctypes.c_char_p
    return lib


def fused_cv_emit(la: torch.Tensor, rb: torch.Tensor,
                  bias: Optional[torch.Tensor], max_disp: int, *,
                  elu: bool = True) -> torch.Tensor:
    """The six conv maps -> (N, D, H, W, K) conv3D_1 output (see the module
    docstring).

    CPU tensors take `fused_cv_emit_plain`. CUDA tensors launch the kernel
    on the current stream and add one to ``fused_cv_emit.launches``; they
    must be contiguous and on one device."""
    _check(la, rb, bias, max_disp)
    tensors = (la, rb) if bias is None else (la, rb, bias)
    if all(t.device.type == "cpu" for t in tensors):
        return fused_cv_emit_plain(la, rb, bias, max_disp, elu=elu)
    if not (la.is_cuda and all(t.device == la.device for t in tensors)):
        raise ValueError("la, rb and bias must lie on one CUDA device (or "
                         "all on the CPU); got "
                         f"{[str(t.device) for t in tensors]}")
    if not (la.is_contiguous() and rb.is_contiguous()):
        raise ValueError("the CUDA kernel takes contiguous NHWC maps")
    n, h, w, k3 = la.shape
    if n > 65535 or h > 65535:
        raise ValueError(f"N and H must be <= 65535 (grid limit); got {n}, {h}")
    k = k3 // 3
    b = (torch.zeros(k, device=la.device) if bias is None
         else bias.float().contiguous())
    out = torch.empty((n, max_disp, h, w, k), dtype=la.dtype,
                      device=la.device)
    lib = _lib()
    err = lib.fused_cv_emit_launch(
        la.data_ptr(), rb.data_ptr(), b.data_ptr(), out.data_ptr(), n, h, w,
        k, int(max_disp), int(elu), int(la.dtype == torch.bfloat16),
        la.device.index, torch.cuda.current_stream(la.device).cuda_stream)
    if err:
        raise RuntimeError(
            f"fused_cv_emit kernel launch failed: CUDA error {err} "
            f"({lib.fused_cv_emit_error_string(err).decode()})")
    fused_cv_emit.launches += 1
    return out


fused_cv_emit.launches = 0
