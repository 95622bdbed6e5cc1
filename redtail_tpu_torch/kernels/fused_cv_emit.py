"""Fused cost volume + conv3D_1, per-disparity assembly: the hand-written
CUDA kernel, its plain PyTorch version and the wrapper that chooses between
them by device.

From the six 2D conv maps of `ops/fused_cost_volume_conv.py`

    la (N, H, W, 3K) = [a0 | a1 | a2],  rb (N, H, W, 6K) = [bk0 | bk1 | bk2 | cc0 | cc1 | cc2]

it assembles conv3D_1's output over the concat cost volume,
(N, D, H, W, K) in the maps' dtype (``layout="full"``), or the packed 3D
head's dh-shifted (N, (D + 1) // 2 + 1, (H + 1) // 2 + 1, W, 4K)
(``layout="dh_shifted"``), with the bias and (``elu=True``) the ELU fused,
accumulated in fp32 and rounded once. It replaces the TPU kernel
`redtail_tpu/kernels/fused_cv_emit_pallas.py:65` (`_emit_kernel`), whose
output is the dh-shifted layout; the formula and the design notes are in
`redtail_tpu_torch/csrc/fused_cv_emit.cu`.

The kernel is built around its write path: K is a compile-time constant
at the served widths (32, 64), a thread owns 8 consecutive channels of one
column (one channel when K % 8 != 0) across its block's disparities and
writes each (d, x) as one 16-byte store, and the outputs with a
boundary-column term are recomputed by a small second pass, so the bulk
runs no boundary code.

The wrapper runs the plain version only for tensors on the CPU. For CUDA
tensors it launches the kernel or raises; nothing falls back. It calls the
custom op `redtail_torch::fused_cv_emit` (`_ops.py`), whose body is
`_forward`, so `torch.export` traces through it. The kernel
has no backward yet, so on CUDA tensors that require grad, with grad mode
on, the wrapper raises (`_build.refuse_autograd`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from redtail_tpu_torch import on_device
from redtail_tpu_torch.kernels import _build

DTYPES = (torch.float32, torch.bfloat16)
LAYOUTS = ("full", "dh_shifted")
MAX_GROUPS = 1024  # threads of one column: one block holds at most 1024


def _pack_dh_shifted(full: torch.Tensor) -> torch.Tensor:
    """(N, D, H, W, K) -> (N, (D + 1) // 2 + 1, (H + 1) // 2 + 1, W, 4K):
    depth slot ``ad`` holds d = 2 ad - 1 + qd, row slot ``hq`` holds row
    2 hq - 1 + qh, channel groups (qh, qd, k), zero outside the input."""
    n, d, h, w, k = full.shape
    dq, hq = (d + 1) // 2 + 1, (h + 1) // 2 + 1
    padded = F.pad(full, (0, 0, 0, 0, 1, 2 * hq - h - 1, 1, 2 * dq - d - 1))
    return (padded.reshape(n, dq, 2, hq, 2, w, k)
            .permute(0, 1, 3, 5, 4, 2, 6).reshape(n, dq, hq, w, 4 * k))


def fused_cv_emit_plain(la: torch.Tensor, rb: torch.Tensor,
                        bias: Optional[torch.Tensor], max_disp: int, *,
                        elu: bool = True,
                        layout: str = "full") -> torch.Tensor:
    """Plain PyTorch version: `d_slices` of the JAX package
    (`ops/fused_cost_volume_conv.py:121-174`) in fp32, rounded once, then
    (``layout="dh_shifted"``) packed."""
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
    if layout == "dh_shifted":
        out = _pack_dh_shifted(out)
    return out.to(la.dtype)


def _check(la, rb, bias, max_disp, layout):
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
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


def _on_cpu(la, rb, bias) -> bool:
    """True where every input is on the CPU; raises on inputs the kernel
    does not take."""
    tensors = (la, rb) if bias is None else (la, rb, bias)
    if all(t.device.type == "cpu" for t in tensors):
        return True
    if not (la.is_cuda and all(t.device == la.device for t in tensors)):
        raise ValueError("la, rb and bias must lie on one CUDA device (or "
                         "all on the CPU); got "
                         f"{[str(t.device) for t in tensors]}")
    if not (la.is_contiguous() and rb.is_contiguous()):
        raise ValueError("the CUDA kernel takes contiguous NHWC maps")
    return False


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_cv_emit")
    lib.fused_cv_emit_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    lib.fused_cv_emit_launch.restype = ctypes.c_int
    lib.fused_cv_emit_error_string.argtypes = [ctypes.c_int]
    lib.fused_cv_emit_error_string.restype = ctypes.c_char_p
    return lib


def _launch(la, rb, bias, max_disp, elu, layout) -> torch.Tensor:
    n, h, w, k3 = la.shape
    if n > 65535 or h > 65535:
        raise ValueError(f"N and H must be <= 65535 (grid limit); got {n}, {h}")
    k = k3 // 3
    packed = layout == "dh_shifted"
    groups = (4 if packed else 1) * (k if k % 8 else k // 8)
    if groups > MAX_GROUPS:
        raise ValueError(f"K={k} is too wide for the {layout} kernel: a "
                         f"column takes (4 if dh_shifted else 1) * K / 8 "
                         f"(K % 8 == 0) or * K threads, at most {MAX_GROUPS}")
    b = (torch.zeros(k, device=la.device) if bias is None
         else bias.float().contiguous())
    shape = ((n, (max_disp + 1) // 2 + 1, (h + 1) // 2 + 1, w, 4 * k)
             if packed else (n, max_disp, h, w, k))
    out = torch.empty(shape, dtype=la.dtype, device=la.device)
    for t in (la, rb, out):
        if t.data_ptr() % 16:
            raise ValueError("tensor storage not aligned to 16 bytes")
    lib = _lib()
    with on_device(la.device):
        err = lib.fused_cv_emit_launch(
            la.data_ptr(), rb.data_ptr(), b.data_ptr(), out.data_ptr(), n, h,
            w, k, int(max_disp), int(elu), int(la.dtype == torch.bfloat16),
            int(packed), la.device.index,
            torch.cuda.current_stream(la.device).cuda_stream)
    if err:
        raise RuntimeError(
            f"fused_cv_emit kernel launch failed: CUDA error {err} "
            f"({lib.fused_cv_emit_error_string(err).decode()})")
    fused_cv_emit.launches += 1
    fused_cv_emit.packed_launches += packed
    return out


def _forward(la, rb, bias, max_disp, elu, layout) -> torch.Tensor:
    """One call, the body of the op `redtail_torch::fused_cv_emit`
    (`_ops.py`): the plain version on the CPU, else the kernel, counted on
    the wrapper."""
    if _on_cpu(la, rb, bias):
        return fused_cv_emit_plain(la, rb, bias, max_disp, elu=elu,
                                   layout=layout)
    return _launch(la, rb, bias, max_disp, elu, layout)


def fused_cv_emit(la: torch.Tensor, rb: torch.Tensor,
                  bias: Optional[torch.Tensor], max_disp: int, *,
                  elu: bool = True, layout: str = "full") -> torch.Tensor:
    """The six conv maps -> conv3D_1's output in ``layout`` (see the module
    docstring).

    CPU tensors take `fused_cv_emit_plain`. CUDA tensors launch the kernel
    on the current stream and add one to ``fused_cv_emit.launches`` (and,
    for the dh-shifted layout, to ``fused_cv_emit.packed_launches``); they
    must be contiguous, 16-byte aligned and on one device, with at most
    `MAX_GROUPS` threads to a column. Both go through the custom op
    `redtail_torch::fused_cv_emit`, except a CPU call that needs grad,
    which runs the differentiable plain version itself."""
    _check(la, rb, bias, max_disp, layout)
    if _on_cpu(la, rb, bias):
        if _build.needs_grad(la, rb, bias):
            return fused_cv_emit_plain(la, rb, bias, max_disp, elu=elu,
                                       layout=layout)
    else:
        _build.refuse_autograd("fused_cv_emit", la, rb, bias)
    return torch.ops.redtail_torch.fused_cv_emit(la, rb, bias, int(max_disp),
                                                 bool(elu), layout)


fused_cv_emit.launches = 0
fused_cv_emit.packed_launches = 0
