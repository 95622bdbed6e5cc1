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
tensors it launches the kernel or raises; nothing falls back. Without grad
it calls the custom op `redtail_torch::cost_volume_concat` (`_ops.py`),
whose body is `_forward`, so `torch.export` traces through it. Where grad
mode is on and an input requires grad, the wrapper runs as a
`torch.autograd.Function` whose backward is the kernel of
`csrc/cost_volume_concat_bwd.cu` (`cost_volume_concat_bwd`, with its plain
version and launch counter): from the volume's cotangent g,

    dL[n, h, x, c] = sum_d g[n, d, h, x, c]
    dR[n, h, y, c] = sum_d g[n, d, h, y + d, C + c]   (y + d < W)

in fp32, rounded once, the gradient XLA derives for the JAX package's
`ops/cost_volume.py:cost_volume` (the Pallas kernel has no VJP).
`bwd_tile_plan` is that kernel's division of the work, computed here so the
CPU tests can emulate it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
from torch.autograd.function import once_differentiable

from redtail_tpu_torch.kernels import _build

DTYPES = (torch.float32, torch.bfloat16)


BWD_THREADS = 256  # threads a block of the backward kernel


@dataclasses.dataclass(frozen=True)
class BwdTilePlan:
    """The backward kernel's division of rows of width ``w``, ``c``
    channels of ``elt`` bytes and ``d`` disparities: a thread (unit) owns
    one ``word`` of bytes, ``v`` channels, of column y of one row and writes
    both dL[y] and dR[y] there; it sums, over ascending d, the word of the
    left half of record (d, y) and, where y + d < w, that of the right half
    of record (d, y + d). Units run channel word fastest, then y, then the
    row, `BWD_THREADS` a block."""

    w: int
    c: int
    d: int
    elt: int
    word: int

    @property
    def v(self) -> int:
        """Channels a word."""
        return self.word // self.elt

    @property
    def units_per_row(self) -> int:
        return self.w * (self.c // self.v)

    def unit(self, u: int):
        """Unit ``u`` -> (row n * H + h, column y, first channel)."""
        px, k = divmod(u, self.c // self.v)
        row, y = divmod(px, self.w)
        return row, y, k * self.v


def bwd_tile_plan(w: int, c: int, d: int, dtype: torch.dtype) -> BwdTilePlan:
    """The backward kernel's plan: the widest word (16, 8, 4 or 2 bytes,
    at least one element) that divides a half record of ``c`` channels."""
    elt = torch.empty((), dtype=dtype).element_size()
    word = next(b for b in (16, 8, 4, 2) if b >= elt and c * elt % b == 0)
    return BwdTilePlan(w=w, c=c, d=d, elt=elt, word=word)


def cost_volume_concat_plain(left: torch.Tensor, right: torch.Tensor,
                             max_disp: int) -> torch.Tensor:
    """Plain PyTorch version: one shifted copy per disparity."""
    n, h, w, c = left.shape
    out = left.new_zeros((n, max_disp, h, w, 2 * c))
    out[..., :c] = left.unsqueeze(1)
    for d in range(min(max_disp, w)):
        out[:, d, :, d:, c:] = right[:, :, :w - d]
    return out


def cost_volume_concat_bwd_plain(g: torch.Tensor, max_disp: int):
    """Plain PyTorch version of the backward: (dL, dR) in g's dtype from
    the (N, D, H, W, 2C) cotangent, summed over D in fp32."""
    n, _, h, w, c2 = g.shape
    c = c2 // 2
    gf = g.float()
    dl = gf[..., :c].sum(1)
    dr = gf.new_zeros((n, h, w, c))
    for d in range(min(max_disp, w)):
        dr[:, :, :w - d] += gf[:, d, :, d:, c:]
    return dl.to(g.dtype), dr.to(g.dtype)


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


def _on_cpu(left, right) -> bool:
    """True for a CPU pair; raises on a pair the kernel does not take."""
    if left.device.type == "cpu" and right.device.type == "cpu":
        return True
    if not (left.is_cuda and right.device == left.device):
        raise ValueError("left and right must lie on one CUDA device (or "
                         f"both on the CPU); got {left.device} and "
                         f"{right.device}")
    if not (left.is_contiguous() and right.is_contiguous()):
        raise ValueError("the CUDA kernel takes contiguous NHWC tensors")
    return False


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("cost_volume_concat")
    lib.cost_volume_concat_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.cost_volume_concat_launch.restype = ctypes.c_int
    lib.cost_volume_concat_error_string.argtypes = [ctypes.c_int]
    lib.cost_volume_concat_error_string.restype = ctypes.c_char_p
    return lib


def _forward(left, right, max_disp):
    """One forward call, the body of the op
    `redtail_torch::cost_volume_concat` (`_ops.py`): the plain version on
    the CPU, else the kernel, counted on the wrapper."""
    if _on_cpu(left, right):
        return cost_volume_concat_plain(left, right, max_disp)
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


@functools.lru_cache(maxsize=None)
def _lib_bwd() -> ctypes.CDLL:
    lib = _build.load("cost_volume_concat_bwd")
    lib.cost_volume_concat_bwd_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    lib.cost_volume_concat_bwd_launch.restype = ctypes.c_int
    lib.cost_volume_concat_bwd_error_string.argtypes = [ctypes.c_int]
    lib.cost_volume_concat_bwd_error_string.restype = ctypes.c_char_p
    return lib


def cost_volume_concat_bwd(g: torch.Tensor, max_disp: int):
    """The volume's backward: (dL, dR), (N, H, W, C) in g's dtype, from the
    (N, D, H, W, 2C) cotangent ``g`` (see the module docstring).

    A CPU ``g`` takes `cost_volume_concat_bwd_plain`. A CUDA one launches
    the backward kernel on the current stream and adds one to
    ``cost_volume_concat_bwd.launches``."""
    if g.dim() != 5 or g.shape[1] != max_disp or g.shape[-1] % 2:
        raise ValueError(f"g must be (N, {max_disp}, H, W, 2C); got "
                         f"{tuple(g.shape)}")
    if g.dtype not in DTYPES:
        raise TypeError(f"g must be float32 or bfloat16; got {g.dtype}")
    g = g.contiguous()
    if _on_cpu(g, g):
        return cost_volume_concat_bwd_plain(g, max_disp)
    n, _, h, w, c2 = g.shape
    plan = bwd_tile_plan(w, c2 // 2, int(max_disp), g.dtype)
    dleft = torch.empty((n, h, w, c2 // 2), dtype=g.dtype, device=g.device)
    dright = torch.empty_like(dleft)
    word = plan.word  # narrower where a storage offset breaks its alignment
    while any(t.data_ptr() % word for t in (g, dleft, dright)):
        word //= 2
    lib = _lib_bwd()
    err = lib.cost_volume_concat_bwd_launch(
        g.data_ptr(), dleft.data_ptr(), dright.data_ptr(), n, h, w, c2 // 2,
        int(max_disp), int(g.dtype == torch.bfloat16), word, g.device.index,
        torch.cuda.current_stream(g.device).cuda_stream)
    if err:
        raise RuntimeError(
            f"cost_volume_concat backward kernel launch failed: CUDA error "
            f"{err} ({lib.cost_volume_concat_bwd_error_string(err).decode()})")
    cost_volume_concat_bwd.launches += 1
    return dleft, dright


class _Concat(torch.autograd.Function):
    """The kernel (or, on the CPU, its plain version) with the backward
    kernel (or its plain version) as its gradient."""

    @staticmethod
    def forward(ctx, left, right, max_disp):
        ctx.max_disp = max_disp
        return _forward(left, right, max_disp)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        dl, dr = cost_volume_concat_bwd(g, ctx.max_disp)
        return dl, dr, None


def cost_volume_concat(left: torch.Tensor, right: torch.Tensor,
                       max_disp: int) -> torch.Tensor:
    """NHWC pair -> (N, D, H, W, 2C) concat volume (see the module
    docstring).

    CPU tensors take `cost_volume_concat_plain`. CUDA tensors launch the
    kernel on the current stream and add one to
    ``cost_volume_concat.launches``; they must be contiguous NHWC on one
    device. Differentiable: the gradient is `cost_volume_concat_bwd`."""
    _check(left, right, max_disp)
    if _build.needs_grad(left, right):
        return _Concat.apply(left, right, max_disp)
    _on_cpu(left, right)  # raises on a pair the kernel does not take
    return torch.ops.redtail_torch.cost_volume_concat(left, right,
                                                      int(max_disp))


cost_volume_concat.launches = 0
cost_volume_concat_bwd.launches = 0
