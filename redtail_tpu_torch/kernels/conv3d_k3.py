"""The 3D encoder's stride-1 conv and its ELU: the hand-written CUDA kernel,
its plain PyTorch version and the wrapper that chooses between them by
device.

    out[n, d, h, x, :] = elu(round(b + sum over td, th, tw in {0, 1, 2} of
                         x[n, d + td - 1, h + th - 1, x + tw - 1, :]
                         @ k[td, th, tw]))

with x (N, D, H, W, C) zero outside the tensor (TF-SAME padding at stride
1), k (3, 3, 3, C, K) and out (N, D, H, W, K) in x's dtype: the sum in fp32,
the (K,) bias added in fp32, one rounding to x's dtype, then the ELU in x's
dtype. It is ``elu(conv3d_ncdhw(x, w, b, 1))`` of `ops/convolution.py` on
NDHWC memory, the arithmetic of every stride-1 layer of the 3D encoder
(`models/stereo.py:_volume_head`). It replaces no TPU kernel: the JAX
package leaves its 3D convs to XLA.

The bf16 kernel (`csrc/conv3d_k3.cu`) is the 3-tap instance of conv223's
`wgmma` pipeline (`csrc/conv_wgmma.cuh`), the ELU in its epilogue. It reads
the weights K-major, (3, 3, 3, K, C) bf16: `kernel_weights` makes that form
from a layer's (K, C, 3, 3, 3) weight once, at load; `contract_weights`
gives the layer's form back. `tile_plan` is the kernel's tiling. There is
no fp32 kernel: fp32 nets keep the round-once cuDNN conv.

The wrapper runs the plain version only for tensors on the CPU. For CUDA
tensors it launches the kernel or raises; nothing falls back. It calls the
custom op `redtail_torch::conv3d_k3` (`_ops.py`), whose body is `_forward`,
so `torch.export` traces through it and a trace names its region. The
kernel has no backward, so on CUDA tensors that require grad, with grad
mode on, the wrapper raises (`_build.refuse_autograd`).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from redtail_tpu_torch import on_device
from redtail_tpu_torch.kernels import _build
from redtail_tpu_torch.kernels import conv223 as _c223

CHANNELS = (16, 32, 64, 128)  # the C and K the kernel takes
DTYPES = (torch.float32, torch.bfloat16)  # the plain version's


def tile_plan(n: int, d: int, h: int, w: int, c: int,
              k: int) -> _c223.TilePlan:
    """The kernel's tiling for x (n, d, h, w, c) and K = k: the shared
    pipeline's plan (`conv223.plan`) of N * D planes of H rows with 3 taps,
    BN = 32 for K <= 32, 64 for K = 64, else 128; 32-channel chunks
    (64-byte swizzle) for C <= 32, 64-channel ones above; 8-row tiles at
    BN = 32, 4-row ones above (as `csrc/conv3d_k3.cu:launch_k3`)."""
    bn = 32 if k <= 32 else 64 if k <= 64 else 128
    return _c223.plan(n * d, h, w, c, k, bn=bn, taps=3,
                      chunk=32 if c <= 32 else 64, rows=8 if bn == 32 else 4)


def kernel_weights(w: torch.Tensor,
                   dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """A layer's (K, C, 3, 3, 3) weight -> the kernel's K-major (3, 3, 3,
    K, C), contiguous, in ``dtype`` (exact for a bf16 net's fp32
    carrier)."""
    return w.permute(2, 3, 4, 0, 1).to(dtype).contiguous()


def contract_weights(kt: torch.Tensor) -> torch.Tensor:
    """The inverse of `kernel_weights`: (3, 3, 3, K, C) -> (K, C, 3, 3, 3),
    contiguous."""
    return kt.permute(3, 4, 0, 1, 2).contiguous()


def conv3d_k3_plain(x: torch.Tensor, kt: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version on NDHWC ``x``: the model's own arithmetic, the
    round-once conv on fp32 carriers (`ops/convolution.py:_conv_sum`,
    `_add_bias`), then the ELU in x's dtype; differentiable."""
    # imported here: `ops` imports the kernel wrappers
    from redtail_tpu_torch.ops.convolution import _add_bias, _conv_sum
    w = contract_weights(kt).float()
    y = _add_bias(_conv_sum(x.permute(0, 4, 1, 2, 3), w, 1, 1), bias,
                  x.dtype)
    return F.elu(y).permute(0, 2, 3, 4, 1).contiguous()


def _check(x, kt, bias) -> None:
    """Raises on input no version takes."""
    if x.dim() != 5 or kt.dim() != 5 or tuple(kt.shape[:3]) != (3, 3, 3) \
            or kt.shape[4] != x.shape[-1]:
        raise ValueError("x must be (N, D, H, W, C) and kt (3, 3, 3, K, C); "
                         f"got {tuple(x.shape)} and {tuple(kt.shape)}")
    if x.dtype not in DTYPES or kt.dtype != x.dtype:
        raise TypeError("x and kt must both be float32 or bfloat16; got "
                        f"{x.dtype} and {kt.dtype}")
    if min(x.shape) < 1:
        raise ValueError(f"empty input {tuple(x.shape)}")
    if tuple(bias.shape) != (kt.shape[3],):
        raise ValueError(f"bias must be ({kt.shape[3]},); got "
                         f"{tuple(bias.shape)}")


def _on_cpu(x, kt, bias) -> bool:
    """True where every input is on the CPU; raises on inputs the kernel
    does not take."""
    tensors = (x, kt, bias)
    if all(t.device.type == "cpu" for t in tensors):
        return True
    if not (x.is_cuda and all(t.device == x.device for t in tensors)):
        raise ValueError("x, kt and bias must lie on one CUDA device (or "
                         "all on the CPU); got "
                         f"{[str(t.device) for t in tensors]}")
    if x.dtype != torch.bfloat16:
        raise TypeError("the CUDA kernel takes bf16 x and kt (fp32 nets keep "
                        f"the cuDNN conv); got {x.dtype}")
    if not (x.is_contiguous() and kt.is_contiguous()):
        raise ValueError("the CUDA kernel takes contiguous x (N, D, H, W, C) "
                         "and kt")
    c, k = x.shape[-1], kt.shape[3]
    if c not in CHANNELS or k not in CHANNELS:
        raise ValueError(f"the CUDA kernel takes C and K in {CHANNELS}; got "
                         f"C={c}, K={k}")
    return False


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("conv3d_k3")
    lib.conv3d_k3_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + [ctypes.c_void_p])
    lib.conv3d_k3_launch.restype = ctypes.c_int
    lib.conv3d_k3_error_string.argtypes = [ctypes.c_int]
    lib.conv3d_k3_error_string.restype = ctypes.c_char_p
    return lib


def _launch(x, kt, bias) -> torch.Tensor:
    n, d, h, w, c = x.shape
    k = kt.shape[3]
    b = bias.float().contiguous()
    out = torch.empty((n, d, h, w, k), dtype=x.dtype, device=x.device)
    for t in (x, kt, out):
        if t.data_ptr() % 32:
            raise ValueError("tensor storage not aligned to 32 bytes")
    plan = tile_plan(n, d, h, w, c, k)
    lib = _lib()
    with on_device(x.device):
        err = lib.conv3d_k3_launch(
            x.data_ptr(), kt.data_ptr(), b.data_ptr(), out.data_ptr(), n, d,
            h, w, c, k, plan.bn, plan.chunk, plan.edge_rows,
            min(plan.tiles, _c223._sm_count(x.device.index)),
            x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(
            f"conv3d_k3 kernel launch failed: CUDA error {err} "
            f"({lib.conv3d_k3_error_string(err).decode()})")
    conv3d_k3.launches += 1
    return out


def _forward(x, kt, bias) -> torch.Tensor:
    """One call, the body of the op `redtail_torch::conv3d_k3` (`_ops.py`):
    the plain version on the CPU, else the kernel (its tile plan and SM
    count taken here, never while tracing), counted on the wrapper."""
    if _on_cpu(x, kt, bias):
        return conv3d_k3_plain(x, kt, bias)
    return _launch(x, kt, bias)


def conv3d_k3(x: torch.Tensor, kt: torch.Tensor,
              bias: torch.Tensor) -> torch.Tensor:
    """(N, D, H, W, C) x kt (3, 3, 3, K, C) + (K,) bias -> (N, D, H, W, K),
    the conv and its ELU (see the module docstring).

    CPU tensors take `conv3d_k3_plain`. CUDA tensors launch the kernel on
    the current stream and add one to ``conv3d_k3.launches``; they must be
    bf16, contiguous, on one device, 32-byte aligned, with C and K in
    `CHANNELS`. Both go through the custom op `redtail_torch::conv3d_k3`,
    except a CPU call that needs grad, which runs the differentiable plain
    version itself."""
    _check(x, kt, bias)
    if _on_cpu(x, kt, bias):
        if _build.needs_grad(x, kt, bias):
            return conv3d_k3_plain(x, kt, bias)
    else:
        _build.refuse_autograd("conv3d_k3", x, kt, bias)
    return torch.ops.redtail_torch.conv3d_k3(x, kt, bias)


conv3d_k3.launches = 0
