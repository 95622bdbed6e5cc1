"""Correlation cost volume: the hand-written CUDA kernel, its plain PyTorch
versions and the wrappers that choose between them by device.

    vol[n, h, x, d] = sum_c L[n, h, x, c] * R[n, h, x - d, c],  zero where x < d

accumulated in fp32. It replaces the TPU kernel
`redtail_tpu/kernels/cost_volume_pallas.py:43` (`_corr_kernel`); the design
notes are in `redtail_tpu_torch/csrc/corr_cost_volume.cu`. One kernel, three
epilogues:

- `corr_cost_volume(..., layout="dlast")`: (N, H, W, D) in fp32, the JAX
  model's `ops/cost_volume.py:corr_cost_volume_dlast`;
- `corr_cost_volume(..., layout="hdw")`: (N, H, D, W) in the input dtype,
  the Pallas kernel's contract (`corr_cost_volume_pallas`);
- `corr_softargmax`: (N, H, W) fp32, the soft-argmax over D of the `dlast`
  volume (`ops/softargmax.py`, scale 1; the masked zeros take part), the
  ResNet18-2D model's use of it, without the volume in device memory.
  With ``groups=G`` each pixel holds G independent groups of C channels
  and the result is (N, H, W, G): the JAX package's H-packed correlation
  head (`ops/packed2d.py:corr_softargmax_hpacked`, G = 2), whose pad rows
  (original row G h + g at or past ``rows``) come out 0. The features may
  be a channel slice of a wider NHWC map (pixel stride > G C): the kernel
  reads them where they lie. No model path of the port launches the
  grouped form (its towers run as one batch of 2N); the tests hold it
  against the plain version and JAX op by op.

Each wrapper runs its plain version only for tensors on the CPU. For CUDA
tensors it launches the kernel or raises; nothing falls back. Without grad
the wrappers call the custom op `redtail_torch::corr_cost_volume`
(`_ops.py`), whose body is `_forward`, so `torch.export` traces through
them and an exported engine launches the kernel and counts it. Where grad
mode is on and an input requires grad, the wrappers run as
`torch.autograd.Function`s whose backward is the backward kernel of
`csrc/corr_cost_volume_bwd.cu` (the VJP `_corr_bwd` of
`redtail_tpu/kernels/cost_volume_pallas.py:113`):

    dL[x, c] = sum_d g[x, d] R[x - d, c],  dR[y, c] = sum_d g[y + d, d] L[y + d, c]

in fp32, rounded once to the input dtype; for `corr_softargmax` it first
recomputes the volume and its softmax p (the forward keeps no volume) and
forms g_vol[x, d] = g[x] p_d (d - sum_j p_j j), in shared memory only: one
launch, no scratch volume. `corr_cost_volume_bwd` and
`corr_softargmax_bwd` are those backward wrappers, each with its plain
version and launch counter. `tile_plan` and `bwd_tile_plan` are the two
kernels' tilings, computed here so the CPU tests can emulate them.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from redtail_tpu_torch import on_device
from redtail_tpu_torch.kernels import _build

LAYOUTS = ("dlast", "hdw")
DTYPES = (torch.float32, torch.bfloat16)
# The kernel's `mode` argument.
MODES = {"hdw": 0, "dlast": 1, "softargmax": 2}
# The kernel's tiling (`csrc/corr_cost_volume.cu`).
WARPS = 4             # warps a block, each on its own unit of work
WX = 16               # columns x a warp (the m16 of `mma.sync` m16n8k16)
DC = 64               # disparities a chunk


def y_tiles(dc: int) -> int:
    """8-column y tiles a warp covers for a chunk of ``dc`` disparities."""
    return -(-(dc + WX - 1) // 8)


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """The kernel's tiling of one (n, h) row of width ``w``, ``c`` channels
    of ``elt`` bytes and ``d`` disparities: a warp takes WX columns x, the
    N * H * x_groups warps' units in order, 4 to a block."""

    w: int
    c: int
    d: int
    elt: int

    @property
    def x_groups(self) -> int:
        return -(-self.w // WX)

    @property
    def d_chunks(self) -> int:
        return -(-self.d // DC)

    @property
    def nt_max(self) -> int:
        """y tiles the accumulators hold (the kernel's NT): 8 when every
        chunk needs at most 8 (D <= 49), else 10."""
        return 8 if y_tiles(min(self.d, DC)) <= 8 else y_tiles(DC)

    def chunk(self, i: int):
        """Disparity chunk ``i`` -> (d0, dc, nt)."""
        d0 = i * DC
        dc = min(DC, self.d - d0)
        return d0, dc, y_tiles(dc)

    def y_start(self, x0: int, i: int) -> int:
        """First y of the tiles of the warp at x0 in chunk ``i``."""
        d0, _, nt = self.chunk(i)
        return x0 + WX - d0 - 8 * nt

    def warp_out(self, mode: str) -> int:
        """Elements of a warp's output staging: its runs at their shifts."""
        vo = 16 // (self.elt if mode == "hdw" else 4)
        if mode == "dlast":
            return WX * self.d + vo if self.d_chunks == 1 else WX * (DC + vo)
        if mode == "hdw":
            return min(self.d, DC) * (WX + vo)
        return 0

    def smem_bytes(self, mode: str) -> int:
        """Dynamic shared memory of a block."""
        return WARPS * self.warp_out(mode) * (
            self.elt if mode == "hdw" else 4)


def tile_plan(w: int, c: int, d: int, dtype: torch.dtype) -> TilePlan:
    """The kernel's tiling for rows of width ``w``, ``c`` channels of
    ``dtype`` and ``d`` disparities."""
    return TilePlan(w=w, c=c, d=d,
                    elt=torch.empty((), dtype=dtype).element_size())


# The backward kernel's tiling (`csrc/corr_cost_volume_bwd.cu`).
BWD_THREADS = 256     # threads a block, each owning one unit
BWD_TX = 8            # columns (x for dL, y for dR) a unit
# channels a unit, by form: 4 for the fused soft-argmax (each staged g_vol
# value serves twice the products and its recompute halo is shared by
# twice the columns), 2 for the volume forms (64 registers, 4 blocks an SM)
BWD_TC = {"softargmax": 4, "dlast": 2, "hdw": 2}
BWD_SMEM_MAX = 232448  # a block's shared memory with the opt-in


@dataclasses.dataclass(frozen=True)
class BwdTilePlan:
    """The backward kernel's tiling of rows of width ``w``, ``c`` channels
    and ``d`` disparities for one form: a block of `BWD_THREADS` threads
    owns ``seg`` columns [s0, s0 + seg) of one row and writes dL and dR
    there; its units (`BWD_TX` columns by ``tc`` channels: the dL units,
    then the dR units) are one a thread. Disparities go in chunks of
    `DC`; a chunk stages its g_vol as gvL[d][x - s0] and gvR[d][y - s0] =
    g_vol[y + d, d], R from y = s0 - d0 - db + 1 and L from x = s0 + d0,
    seg + db rows each (the D - 1 columns past the segment are its
    halo)."""

    w: int
    c: int
    d: int
    elt: int
    tc: int
    seg: int

    @property
    def cg(self) -> int:
        """Channel groups of ``tc``."""
        return -(-self.c // self.tc)

    @property
    def segs(self) -> int:
        return -(-self.w // self.seg)

    @property
    def tiles(self) -> int:
        return self.seg // BWD_TX

    @property
    def units(self) -> int:
        return 2 * self.tiles * self.cg

    @property
    def passes(self) -> int:
        return -(-self.units // BWD_THREADS)

    @property
    def db(self) -> int:
        """Disparity rows a chunk stages."""
        return min(-(-self.d // 4) * 4, DC)

    @property
    def d_chunks(self) -> int:
        return -(-self.d // DC)

    def chunk(self, i: int):
        """Disparity chunk ``i`` -> (d0, dc, rows summed: dc rounded up to
        4, the rows past dc zero)."""
        d0 = i * DC
        dc = min(DC, self.d - d0)
        return d0, dc, -(-dc // 4) * 4

    def unit(self, u: int):
        """Unit ``u`` -> ("dl" or "dr", first column offset in the segment,
        first channel)."""
        half = self.units // 2
        kind, u = ("dl", u) if u < half else ("dr", u - half)
        tile, cg = divmod(u, self.cg)
        return kind, BWD_TX * tile, self.tc * cg

    def smem_bytes(self) -> int:
        """Dynamic shared memory of a block: gvL and gvR, Ls and Rs, the
        per-x softmax state (`softargmax` with D > `DC`)."""
        return 4 * bwd_smem_floats(self.seg, self.cg, self.tc, self.db,
                                   self.d)


def bwd_smem_floats(seg: int, cg: int, tc: int, db: int, d: int) -> int:
    stats = -(-(seg + d) // 4) * 4
    return 2 * db * (seg + 4) + 2 * (seg + db) * tc * cg + 3 * stats


def bwd_tile_plan(w: int, c: int, d: int, dtype: torch.dtype,
                  mode: str = "softargmax") -> BwdTilePlan:
    """The backward kernel's tiling for the form ``mode``: the widest
    segment whose units fill one thread each (at C = 32, 128 columns for
    `softargmax`, 64 for `dlast` / `hdw`), at most the row, narrowed until
    its shared memory fits a block. Raises ValueError where no segment
    fits (D in the thousands)."""
    elt = torch.empty((), dtype=dtype).element_size()
    tc = BWD_TC[mode]
    cg = -(-c // tc)
    seg = BWD_TX * max(1, BWD_THREADS // (2 * cg))
    seg = min(seg, -(-w // BWD_TX) * BWD_TX)
    db = min(-(-d // 4) * 4, DC)
    while (seg > BWD_TX
           and 4 * bwd_smem_floats(seg, cg, tc, db, d) > BWD_SMEM_MAX):
        seg -= BWD_TX
    if 4 * bwd_smem_floats(seg, cg, tc, db, d) > BWD_SMEM_MAX:
        raise ValueError(f"the backward kernel's shared memory cannot hold "
                         f"C={c}, D={d}")
    return BwdTilePlan(w=w, c=c, d=d, elt=elt, tc=tc, seg=seg)


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


def corr_softargmax_plain(left: torch.Tensor, right: torch.Tensor,
                          max_disp: int, groups: int = 1,
                          rows: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of the fused epilogue: the `dlast` volume,
    then `ops/softargmax.py:softargmax` over its last axis; with
    ``groups`` > 1 one volume and soft-argmax per group, (N, H, W, G),
    entries of original row G h + g >= ``rows`` set to 0 (the H-packed
    layout's pad rows)."""
    # imported here: `ops` imports this module through `ops/cost_volume.py`
    from redtail_tpu_torch.ops.softargmax import softargmax

    if groups == 1 and rows is None:
        return softargmax(
            corr_cost_volume_plain(left, right, max_disp, layout="dlast"),
            axis=-1)
    n, h, w, gc = left.shape
    c = gc // groups

    def rows_of(x):   # (N, H, W, G C) -> (N H G, 1, W, C): a row a group
        return x.reshape(n, h, w, groups, c).permute(0, 1, 3, 2, 4) \
            .reshape(n * h * groups, 1, w, c)
    out = softargmax(corr_cost_volume_plain(rows_of(left), rows_of(right),
                                            max_disp), axis=-1)
    out = out.reshape(n, h, groups, w).permute(0, 1, 3, 2).contiguous()
    if rows is not None:
        orig = (groups * torch.arange(h, device=out.device)[:, None]
                + torch.arange(groups, device=out.device))  # (H, G)
        out = out.masked_fill((orig >= rows)[:, None, :], 0.0)
    return out


def corr_cost_volume_bwd_plain(left: torch.Tensor, right: torch.Tensor,
                               g: torch.Tensor, max_disp: int, *,
                               layout: str = "dlast"):
    """Plain PyTorch version of the backward: (dL, dR) in the inputs'
    dtype from the volume's cotangent ``g`` ((N, H, W, D) for `dlast`,
    (N, H, D, W) for `hdw`), one shifted product per disparity in fp32."""
    w = left.shape[2]
    gv = g.float() if layout == "dlast" else g.float().permute(0, 1, 3, 2)
    lf, rf = left.float(), right.float()
    dl, dr = torch.zeros_like(lf), torch.zeros_like(rf)
    for d in range(min(max_disp, w)):
        gd = gv[:, :, d:, d, None]
        dl[:, :, d:] += gd * rf[:, :, :w - d]
        dr[:, :, :w - d] += gd * lf[:, :, d:]
    return dl.to(left.dtype), dr.to(right.dtype)


def corr_softargmax_bwd_plain(left: torch.Tensor, right: torch.Tensor,
                              g: torch.Tensor, max_disp: int):
    """Plain PyTorch version of the fused epilogue's backward: the volume
    recomputed, g_vol = g p (d - mu) with p its softmax over D (the masked
    zeros included) and mu = sum_d p_d d, then the volume's backward (which
    reads no entry x < d)."""
    vol = corr_cost_volume_plain(left, right, max_disp, layout="dlast")
    p = torch.softmax(vol, dim=-1)
    idx = torch.arange(max_disp, dtype=torch.float32, device=vol.device)
    mu = (p * idx).sum(-1, keepdim=True)
    gvol = g.float().unsqueeze(-1) * p * (idx - mu)
    return corr_cost_volume_bwd_plain(left, right, gvol, max_disp)


def _check(left, right, max_disp, groups: int = 1):
    if left.dim() != 4 or left.shape != right.shape:
        raise ValueError("left and right must be NHWC tensors of one shape; "
                         f"got {tuple(left.shape)} and {tuple(right.shape)}")
    if int(groups) != groups or groups < 1 or left.shape[-1] % groups:
        raise ValueError(f"groups must be an integer >= 1 dividing the "
                         f"{left.shape[-1]} channels, got {groups}")
    if left.dtype not in DTYPES or right.dtype != left.dtype:
        raise TypeError("left and right must both be float32 or bfloat16; "
                        f"got {left.dtype} and {right.dtype}")
    if min(left.shape) < 1:
        raise ValueError(f"empty input {tuple(left.shape)}")
    if int(max_disp) != max_disp or max_disp < 1:
        raise ValueError(f"max_disp must be an integer >= 1, got {max_disp}")


def _rows_of_pixels(x: torch.Tensor) -> bool:
    """Whether NHWC ``x`` has unit channel stride and its pixels back to
    back at one stride >= its channels: a contiguous map or a channel slice
    of one."""
    n, h, w, c = x.shape
    s = x.stride(2)
    return (x.stride(3) == 1 or c == 1) and s >= c and \
        (h == 1 or x.stride(1) == w * s) and \
        (n == 1 or x.stride(0) == h * w * s)


def _on_cpu(left, right, groups: int = 1) -> bool:
    """True for a CPU pair; raises on a pair the kernel does not take."""
    if left.device.type == "cpu" and right.device.type == "cpu":
        return True
    if not (left.is_cuda and right.device == left.device):
        raise ValueError("left and right must lie on one CUDA device (or "
                         f"both on the CPU); got {left.device} and "
                         f"{right.device}")
    if groups > 1:
        if not (_rows_of_pixels(left) and _rows_of_pixels(right)
                and left.stride() == right.stride()):
            raise ValueError("the grouped CUDA kernel takes NHWC maps of one "
                             "pixel stride with their pixels back to back "
                             "(contiguous, or channel slices of one)")
    elif not (left.is_contiguous() and right.is_contiguous()):
        raise ValueError("the CUDA kernel takes contiguous NHWC tensors")
    n, h, w, _ = left.shape
    if n * h * groups * -(-w // WX) > 2 ** 31 - 1 - 32 * WARPS:
        raise ValueError(f"N * H * G * ceil(W / {WX}) warps must be < "
                         f"2**31; got N={n}, H={h}, G={groups}, W={w}")
    return False


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("corr_cost_volume")
    lib.corr_cost_volume_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 11 + [ctypes.c_void_p])
    lib.corr_cost_volume_launch.restype = ctypes.c_int
    lib.corr_cost_volume_error_string.argtypes = [ctypes.c_int]
    lib.corr_cost_volume_error_string.restype = ctypes.c_char_p
    return lib


def _out_shape(left, max_disp, mode, groups=1):
    n, h, w, _ = left.shape
    if mode == "softargmax":
        return (n, h, w) if groups == 1 else (n, h, w, groups)
    return (n, h, w, max_disp) if mode == "dlast" else (n, h, max_disp, w)


def _launch(left, right, max_disp, mode, groups=1, rows=0) -> torch.Tensor:
    n, h, w, gc = left.shape
    dtype = left.dtype if mode == "hdw" else torch.float32
    out = torch.empty(_out_shape(left, max_disp, mode, groups), dtype=dtype,
                      device=left.device)
    lib = _lib()
    with on_device(left.device):
        err = lib.corr_cost_volume_launch(
            left.data_ptr(), right.data_ptr(), out.data_ptr(), n, h, w,
            gc // groups, int(max_disp), int(left.dtype == torch.bfloat16),
            MODES[mode], groups, left.stride(2) if w > 1 else gc,
            rows or groups * h, left.device.index,
            torch.cuda.current_stream(left.device).cuda_stream)
    if err:
        raise RuntimeError(
            f"corr_cost_volume kernel launch failed ({mode}): CUDA error "
            f"{err} ({lib.corr_cost_volume_error_string(err).decode()})")
    return out


@functools.lru_cache(maxsize=None)
def _lib_bwd() -> ctypes.CDLL:
    lib = _build.load("corr_cost_volume_bwd")
    lib.corr_cost_volume_bwd_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    lib.corr_cost_volume_bwd_launch.restype = ctypes.c_int
    lib.corr_cost_volume_bwd_error_string.argtypes = [ctypes.c_int]
    lib.corr_cost_volume_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _grad_input(g, left, max_disp, mode):
    """The cotangent as the backward kernel reads it: contiguous, in the
    input dtype for `hdw` and fp32 otherwise (both exact casts of what
    the forward returned), of the forward's output shape."""
    n, h, w, _ = left.shape
    shape, dtype = {"dlast": ((n, h, w, max_disp), torch.float32),
                    "hdw": ((n, h, max_disp, w), left.dtype),
                    "softargmax": ((n, h, w), torch.float32)}[mode]
    if tuple(g.shape) != shape:
        raise ValueError(f"the {mode} cotangent must be {shape}; got "
                         f"{tuple(g.shape)}")
    if g.device != left.device:
        raise ValueError(f"the cotangent lies on {g.device}, the features "
                         f"on {left.device}")
    return g.to(dtype).contiguous()


def _launch_bwd(left, right, g, max_disp, mode):
    n, h, w, c = left.shape
    g = _grad_input(g, left, max_disp, mode)
    plan = bwd_tile_plan(w, c, int(max_disp), left.dtype, mode)
    if n * h * plan.segs > 2 ** 31 - 1:
        raise ValueError(f"N * H * {plan.segs} segments must be < 2**31; "
                         f"got N={n}, H={h}")
    dleft, dright = torch.empty_like(left), torch.empty_like(right)
    lib = _lib_bwd()
    with on_device(left.device):
        err = lib.corr_cost_volume_bwd_launch(
            left.data_ptr(), right.data_ptr(), g.data_ptr(),
            dleft.data_ptr(), dright.data_ptr(), n, h, w, c, int(max_disp),
            int(left.dtype == torch.bfloat16), MODES[mode], plan.seg,
            left.device.index,
            torch.cuda.current_stream(left.device).cuda_stream)
    if err:
        raise RuntimeError(
            f"corr_cost_volume backward kernel launch failed ({mode}): CUDA "
            f"error {err} "
            f"({lib.corr_cost_volume_bwd_error_string(err).decode()})")
    return dleft, dright


def corr_cost_volume_bwd(left: torch.Tensor, right: torch.Tensor,
                         g: torch.Tensor, max_disp: int, *,
                         layout: str = "dlast"):
    """The volume's backward: (dL, dR) in the inputs' dtype from its
    cotangent ``g`` (see the module docstring).

    CPU tensors take `corr_cost_volume_bwd_plain`. CUDA tensors launch the
    backward kernel on the current stream and add one to
    ``corr_cost_volume_bwd.launches``."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    _check(left, right, max_disp)
    if _on_cpu(left, right):
        return corr_cost_volume_bwd_plain(
            left, right, _grad_input(g, left, max_disp, layout), max_disp,
            layout=layout)
    out = _launch_bwd(left, right, g, max_disp, layout)
    corr_cost_volume_bwd.launches += 1
    return out


def corr_softargmax_bwd(left: torch.Tensor, right: torch.Tensor,
                        g: torch.Tensor, max_disp: int):
    """The fused epilogue's backward: (dL, dR) in the inputs' dtype from
    the (N, H, W) cotangent ``g``, the volume recomputed (see the module
    docstring).

    CPU tensors take `corr_softargmax_bwd_plain`. CUDA tensors launch the
    backward kernel once on the current stream and add one to
    ``corr_softargmax_bwd.launches``."""
    _check(left, right, max_disp)
    if _on_cpu(left, right):
        return corr_softargmax_bwd_plain(
            left, right, _grad_input(g, left, max_disp, "softargmax"),
            max_disp)
    out = _launch_bwd(left, right, g, max_disp, "softargmax")
    corr_softargmax_bwd.launches += 1
    return out


def _forward(left, right, max_disp, mode, groups=1, rows=0):
    """One forward call, the body of the op
    `redtail_torch::corr_cost_volume` (`_ops.py`): the plain version on the
    CPU, else the kernel, counted on its wrapper (a grouped launch also on
    ``corr_softargmax.grouped_launches``). ``rows`` 0: no pad rows."""
    if _on_cpu(left, right, groups):
        if mode == "softargmax":
            return corr_softargmax_plain(left, right, max_disp, groups,
                                         rows or None)
        return corr_cost_volume_plain(left, right, max_disp, layout=mode)
    out = _launch(left, right, max_disp, mode, groups, rows)
    if mode == "softargmax":
        corr_softargmax.launches += 1
        corr_softargmax.grouped_launches += groups > 1
    else:
        corr_cost_volume.launches += 1
    return out


class _Corr(torch.autograd.Function):
    """The kernel (or, on the CPU, its plain version) with the backward
    kernel (or its plain version) as its gradient. Both are deterministic,
    so a recompute under activation checkpointing gives the same bits."""

    @staticmethod
    def forward(ctx, left, right, max_disp, mode):
        ctx.save_for_backward(left, right)
        ctx.max_disp, ctx.mode = max_disp, mode
        return _forward(left, right, max_disp, mode)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        left, right = ctx.saved_tensors
        if ctx.mode == "softargmax":
            dl, dr = corr_softargmax_bwd(left, right, g, ctx.max_disp)
        else:
            dl, dr = corr_cost_volume_bwd(left, right, g, ctx.max_disp,
                                          layout=ctx.mode)
        return dl, dr, None, None


def _call(left, right, max_disp, mode):
    if _build.needs_grad(left, right):
        return _Corr.apply(left, right, max_disp, mode)
    _on_cpu(left, right)  # raises on a pair the kernel does not take
    return torch.ops.redtail_torch.corr_cost_volume(left, right,
                                                    int(max_disp), mode)


def corr_cost_volume(left: torch.Tensor, right: torch.Tensor, max_disp: int,
                     *, layout: str = "dlast") -> torch.Tensor:
    """NHWC pair -> correlation volume (see the module docstring).

    CPU tensors take `corr_cost_volume_plain`. CUDA tensors launch the
    kernel on the current stream and add one to ``corr_cost_volume.launches``;
    they must be contiguous NHWC on one device. Differentiable: the
    gradient is `corr_cost_volume_bwd`."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    _check(left, right, max_disp)
    return _call(left, right, max_disp, layout)


def corr_softargmax(left: torch.Tensor, right: torch.Tensor,
                    max_disp: int, *, groups: int = 1,
                    rows: Optional[int] = None) -> torch.Tensor:
    """NHWC pair -> (N, H, W) fp32 soft-argmax over D of the correlation
    volume, or with ``groups`` > 1 (N, H, W, G), one per group, entries of
    original row G h + g >= ``rows`` set to 0 (see the module docstring).

    CPU tensors take `corr_softargmax_plain`. CUDA tensors launch the
    kernel's fused epilogue on the current stream and add one to
    ``corr_softargmax.launches`` (and a grouped launch to
    ``corr_softargmax.grouped_launches``); they must be contiguous NHWC on
    one device, or for ``groups`` > 1 channel slices of one pixel stride.
    Differentiable with ``groups=1``: the gradient is
    `corr_softargmax_bwd`. A grouped launch is a serving path: on CUDA
    inputs that require grad it raises (`_build.refuse_autograd`); on the
    CPU the plain version is differentiable."""
    _check(left, right, max_disp, groups)
    if rows is not None and (int(rows) != rows or rows < 1):
        raise ValueError(f"rows must be an integer >= 1, got {rows}")
    if groups == 1 and rows is None:
        return _call(left, right, max_disp, "softargmax")
    if _on_cpu(left, right, groups):
        if _build.needs_grad(left, right):
            return corr_softargmax_plain(left, right, max_disp, groups, rows)
    else:
        _build.refuse_autograd("corr_softargmax (groups > 1)", left, right)
    return torch.ops.redtail_torch.corr_cost_volume(
        left, right, int(max_disp), "softargmax", int(groups), int(rows or 0))


corr_cost_volume.launches = 0
corr_softargmax.launches = 0
corr_softargmax.grouped_launches = 0
corr_cost_volume_bwd.launches = 0
corr_softargmax_bwd.launches = 0
