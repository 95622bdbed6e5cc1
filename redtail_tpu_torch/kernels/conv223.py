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
kernel `redtail_tpu/kernels/conv223_pallas.py:60` (`_conv223_kernel`).

The bf16 kernel is a warp-specialised, persistent `wgmma` implicit GEMM fed
by TMA (design notes in `redtail_tpu_torch/csrc/conv223.cu`). It reads the
weights K-major, (2, 2, 3, K, C): `kernel_weights` makes that form once (the
packed head does it at load, `ops/packed3d.py:prepare`) and
``conv223(..., k_layout="kc")`` takes it; `contract_weights` gives back the
(2, 2, 3, C, K) form. `tile_plan` is the kernel's tiling, computed here and
handed to it.

The wrapper runs the plain version only for tensors on the CPU. For CUDA
tensors it launches the kernel or raises; nothing falls back. It calls the
custom op `redtail_torch::conv223` (`_ops.py`), whose body is `_forward`,
so `torch.export` traces through it. The kernel
has no backward yet, so on CUDA tensors that require grad, with grad mode
on, the wrapper raises (`_build.refuse_autograd`).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from redtail_tpu_torch import on_device
from redtail_tpu_torch.kernels import _build

DTYPES = (torch.float32, torch.bfloat16)
K_LAYOUTS = ("ck", "kc")
MAX_C = 256  # the fp32 kernel stages a whole (4, 34, C) window

# The bf16 kernel's tiling (csrc/conv223.cu): a tile is TH rows x TW
# columns of one (n, d) plane, 256 output pixels; each K-step stages
# TH x (TW + 2) pixels of 64 channels.
TH, TW = 4, 64
TILE_PIXELS = TH * TW
SLAB_PIXELS = TH * (TW + 2)
CHUNK = 64


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """The bf16 kernel's tiles for one call. Main tiles are rows x TW; the
    ``rem = W % TW`` columns past the last full TW form edge tiles of
    ``edge_rows`` rows each. Tiles are ordered (N tile, n, d, main tiles by
    row then column, edge tiles). conv223 takes ``taps`` = 2 and 64-channel
    chunks; `conv3d_k3.tile_plan` plans the shared pipeline's 3-tap form."""

    bn: int           # output channels of an N tile: 32, 64 or 128
    n_tiles: int      # ceil(K / bn)
    chunks: int       # reduction chunks: ceil(C / chunk)
    hout: int
    row_tiles: int    # ceil(Hout / rows)
    col_tiles: int    # W // TW
    rem: int          # W % TW
    edge_rows: int    # rows of an edge tile (1 without edge tiles)
    edge_tiles: int   # edge tiles of a plane
    planes: int       # N * Dout
    taps: int = 2     # taps along D and along H
    chunk: int = CHUNK  # channels of a reduction chunk: 32 or 64
    rows: int = TH    # rows of a main tile: 4 or 8
    halo_cols: int = 2  # columns staged past a tile's: 2 (3 taps along W)
    halo_rows: int = 0  # rows staged past a tile's, once for every tap

    @property
    def per_plane(self) -> int:
        return self.row_tiles * self.col_tiles + self.edge_tiles

    @property
    def tiles(self) -> int:
        return self.n_tiles * self.planes * self.per_plane

    @property
    def steps(self) -> int:
        """K-steps of a tile: (chunk, td, th)."""
        return self.taps * self.taps * self.chunks

    def tile(self, r: int):
        """Tile ``r`` of a plane -> (h0, x0, rows, cols); as the kernel's
        `decode`."""
        main = self.row_tiles * self.col_tiles
        if r < main:
            return (r // self.col_tiles) * self.rows, \
                (r % self.col_tiles) * TW, self.rows, TW
        return (r - main) * self.edge_rows, self.col_tiles * TW, \
            self.edge_rows, self.rem


def plan(planes: int, hout: int, w: int, c: int, k: int, *, bn: int,
         taps: int = 2, chunk: int = CHUNK, rows: int = TH,
         halo_cols: int = 2, halo_rows: int = 0) -> TilePlan:
    """The shared pipeline's tiling (`csrc/conv_wgmma.cuh`) of ``planes``
    output planes of ``hout`` x ``w`` pixels, C = c, K = k; a main tile is
    ``rows`` x TW pixels, staged as ``rows + halo_rows`` rows of ``TW +
    halo_cols`` columns (conv223 and conv3d_k3: rows / 2 m64 blocks a
    consumer warpgroup, 2 halo columns, no halo row).

    An edge tile stages ``(edge_rows + halo_rows) * (rem + halo_cols)``
    pixels (at most what a main tile stages, and at most 256 rows, TMA's
    largest box) and computes ``edge_rows * rem`` outputs (at most ``rows
    * TW``), so at W % 64 = 1 (W = 513, 257) a plane's last column is one
    tile of its own rather than a row of 64-column tiles holding one
    column each."""
    rem = w % TW
    staged = (rows + halo_rows) * (TW + halo_cols)
    edge_rows = (min(staged // (rem + halo_cols) - halo_rows,
                     rows * TW // rem, hout, 256 - halo_rows)
                 if rem else 1)
    return TilePlan(bn=bn, n_tiles=-(-k // bn), chunks=-(-c // chunk),
                    hout=hout, row_tiles=-(-hout // rows), col_tiles=w // TW,
                    rem=rem, edge_rows=edge_rows,
                    edge_tiles=-(-hout // edge_rows) if rem else 0,
                    planes=planes, taps=taps, chunk=chunk, rows=rows,
                    halo_cols=halo_cols, halo_rows=halo_rows)


def tile_plan(n: int, dp: int, hp: int, w: int, c: int, k: int) -> TilePlan:
    """The tiling of the bf16 kernel for xp (n, dp, hp, w, c) and K = k:
    `plan` of its N * (Dp - 1) planes of Hp - 1 rows, BN = 64 where K <= 64,
    else 128."""
    return plan(n * (dp - 1), hp - 1, w, c, k, bn=64 if k <= 64 else 128)


def kernel_weights(k: torch.Tensor) -> torch.Tensor:
    """(2, 2, 3, C, K) -> the bf16 kernel's K-major (2, 2, 3, K, C),
    contiguous."""
    return k.transpose(3, 4).contiguous()


def contract_weights(kt: torch.Tensor) -> torch.Tensor:
    """The inverse of `kernel_weights`: (2, 2, 3, K, C) -> (2, 2, 3, C, K),
    contiguous."""
    return kt.transpose(3, 4).contiguous()


def conv223_plain(xp: torch.Tensor, k: torch.Tensor,
                  bias: Optional[torch.Tensor]) -> torch.Tensor:
    """Plain PyTorch version, k (2, 2, 3, C, K): the 12 per-tap products
    summed in fp32, the bias added, one cast."""
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


def _check(xp, k, bias, k_layout) -> int:
    """Raises on input no version takes; returns K."""
    if k_layout not in K_LAYOUTS:
        raise ValueError(f"k_layout must be one of {K_LAYOUTS}, got "
                         f"{k_layout!r}")
    c_axis = 3 if k_layout == "ck" else 4
    if xp.dim() != 5 or k.dim() != 5 or tuple(k.shape[:3]) != (2, 2, 3) \
            or k.shape[c_axis] != xp.shape[-1]:
        want = "(2, 2, 3, C, K)" if k_layout == "ck" else "(2, 2, 3, K, C)"
        raise ValueError(f"xp must be (N, Dp, Hp, W, C) and k {want}; got "
                         f"{tuple(xp.shape)} and {tuple(k.shape)}")
    if xp.dtype not in DTYPES or k.dtype != xp.dtype:
        raise TypeError("xp and k must both be float32 or bfloat16; got "
                        f"{xp.dtype} and {k.dtype}")
    if min(xp.shape) < 1 or xp.shape[1] < 2 or xp.shape[2] < 2:
        raise ValueError(f"empty output: xp {tuple(xp.shape)} needs Dp >= 2 "
                         "and Hp >= 2")
    kk = k.shape[4] if k_layout == "ck" else k.shape[3]
    if bias is not None and tuple(bias.shape) != (kk,):
        raise ValueError(f"bias must be ({kk},); got {tuple(bias.shape)}")
    return kk


def _on_cpu(xp, k, bias) -> bool:
    """True where every input is on the CPU; raises on inputs the kernel
    does not take."""
    tensors = (xp, k) if bias is None else (xp, k, bias)
    if all(t.device.type == "cpu" for t in tensors):
        return True
    if not (xp.is_cuda and all(t.device == xp.device for t in tensors)):
        raise ValueError("xp, k and bias must lie on one CUDA device (or all "
                         f"on the CPU); got {[str(t.device) for t in tensors]}")
    if not (xp.is_contiguous() and k.is_contiguous()):
        raise ValueError("the CUDA kernel takes contiguous xp (N, Dp, Hp, W, "
                         "C) and k")
    return False


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("conv223")
    lib.conv223_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + [ctypes.c_void_p])
    lib.conv223_launch.restype = ctypes.c_int
    lib.conv223_error_string.argtypes = [ctypes.c_int]
    lib.conv223_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(xp, k, bias, k_layout) -> torch.Tensor:
    n, dp, hp, w, c = xp.shape
    kk = k.shape[4] if k_layout == "ck" else k.shape[3]
    if c % 16 or kk % 16 or c > MAX_C:
        raise ValueError(f"the CUDA kernel takes C and K multiples of 16 and "
                         f"C <= {MAX_C} (the packed head's 64 or 128); got "
                         f"C={c}, K={kk}")
    bf16 = xp.dtype == torch.bfloat16
    if not bf16 and (n * (dp - 1) > 65535 or hp > 65535):
        raise ValueError(f"N * (Dp - 1) and Hp must be <= 65535 (the fp32 "
                         f"kernel's grid); got {n * (dp - 1)}, {hp}")
    if bf16:
        k = k if k_layout == "kc" else kernel_weights(k)
    elif k_layout == "kc":
        k = contract_weights(k)
    b = (torch.zeros(kk, device=xp.device) if bias is None
         else bias.float().contiguous())
    out = torch.empty((n, dp - 1, hp - 1, w, kk), dtype=xp.dtype,
                      device=xp.device)
    for t in (xp, k, out):
        if t.data_ptr() % 32:
            raise ValueError("tensor storage not aligned to 32 bytes")
    plan = tile_plan(n, dp, hp, w, c, kk)
    lib = _lib()
    with on_device(xp.device):
        err = lib.conv223_launch(
            xp.data_ptr(), k.data_ptr(), b.data_ptr(), out.data_ptr(), n, dp,
            hp, w, c, kk, int(bf16), plan.bn, plan.edge_rows,
            min(plan.tiles, _sm_count(xp.device.index)), xp.device.index,
            torch.cuda.current_stream(xp.device).cuda_stream)
    if err:
        raise RuntimeError(
            f"conv223 kernel launch failed: CUDA error {err} "
            f"({lib.conv223_error_string(err).decode()})")
    conv223.launches += 1
    return out


def _forward(xp, k, bias, k_layout) -> torch.Tensor:
    """One call, the body of the op `redtail_torch::conv223` (`_ops.py`):
    the plain version on the CPU, else the kernel (its tile plan and SM
    count taken here, never while tracing), counted on the wrapper."""
    if _on_cpu(xp, k, bias):
        return conv223_plain(
            xp, k if k_layout == "ck" else contract_weights(k), bias)
    return _launch(xp, k, bias, k_layout)


def conv223(xp: torch.Tensor, k: torch.Tensor, bias: Optional[torch.Tensor],
            k_layout: str = "ck") -> torch.Tensor:
    """(N, Dp, Hp, W, C) x k [+ (K,) bias] -> (N, Dp - 1, Hp - 1, W, K)
    (see the module docstring); k is (2, 2, 3, C, K) (``k_layout="ck"``)
    or `kernel_weights`' (2, 2, 3, K, C) (``"kc"``).

    CPU tensors take `conv223_plain`. CUDA tensors launch the kernel on the
    current stream and add one to ``conv223.launches``; they must be
    contiguous, on one device, 32-byte aligned, with C and K multiples of
    16 and C <= 256. The bf16 kernel reads the "kc" form, the fp32 one the
    "ck" form: the other form is converted per call. Both go through the
    custom op `redtail_torch::conv223`, except a CPU call that needs grad,
    which runs the differentiable plain version itself."""
    _check(xp, k, bias, k_layout)
    if _on_cpu(xp, k, bias):
        if _build.needs_grad(xp, k, bias):
            return conv223_plain(
                xp, k if k_layout == "ck" else contract_weights(k), bias)
    else:
        _build.refuse_autograd("conv223", xp, k, bias)
    return torch.ops.redtail_torch.conv223(xp, k, bias, k_layout)


conv223.launches = 0
