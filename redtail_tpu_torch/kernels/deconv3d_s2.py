"""The 3D decoder's stride-2 transposed conv with its layer's tail: the
hand-written CUDA kernel, its plain PyTorch version and the wrapper that
chooses between them by device.

    out = elu(round(round(b + conv3d_transpose(y, w)) + skip))   (a skip)
    out = round(b + conv3d_transpose(y, w))                      (none)

TF ``conv3d_transpose``, k = 3, stride 2, SAME, on NDHWC memory: y (N, Dy,
Hy, Wy, C), skip and out (N, Xd, Xh, Xw, c_out) with Y = ceil(X / 2) on
each axis, in y's dtype: the sum in fp32, the (c_out,) bias added in fp32,
one rounding to y's dtype, then the skip added and the ELU, each in y's
dtype. It is ``elu(conv3d_transpose_ncdhw(y, w, b) + skip)`` of
`ops/convolution.py`, every decoder layer of the 3D models' fused head
(`models/stereo.py:_volume_head`); the last layer (c_out = 1) has no skip
and no ELU. It replaces no TPU kernel: the JAX package leaves its
transposed convs to XLA.

The kernel (`csrc/deconv3d_s2.cu`) splits the transposed conv by output
parity: along an axis, window position m in [0, Y) gives output 2 m - lo
+ c of class c (lo = 2 Y - X, the TF low pad); offset a = 0 reads y[m - 1],
a = 1 reads y[m], and offset a feeds class c unless a = 0 and c = 1
(`fed`), with tap `TAP[a, c]`. The 27 fed (offset, class) pairs are the
27 taps. It reads the weights in `kernel_weights`' form, made from a
layer's (C, c_out, 3, 3, 3) weight once, at load: (27, c_out, C), a (c_out,
C) slot a fed pair in `slot`'s order, or, where c_out = 1, (8, 8, C), the
8 classes of each offset (zero where not fed). `contract_weights` gives
the layer's form back; `tile_plan` is the kernel's tiling. There is no fp32
kernel: fp32 nets keep cuDNN's transposed conv.

The wrapper runs the plain version only for tensors on the CPU. For CUDA
tensors it launches the kernel or raises; nothing falls back. It calls the
custom op `redtail_torch::deconv3d_s2` (`_ops.py`), whose body is
`_forward`, so `torch.export` traces through it and a trace names its
region. The kernel has no backward, so on CUDA tensors that require grad,
with grad mode on, the wrapper raises (`_build.refuse_autograd`).
"""

from __future__ import annotations

import ctypes
import functools
import itertools
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from redtail_tpu_torch import on_device
from redtail_tpu_torch.kernels import _build
from redtail_tpu_torch.kernels import conv223 as _c223

CHANNELS = (16, 32, 64, 128)   # the C the kernel takes
OUT_CHANNELS = (1, 16, 32, 64)  # the c_out it takes
DTYPES = (torch.float32, torch.bfloat16)  # the plain version's
# along one axis, the tap of window offset a for class c where a feeds c
TAP = {(0, 0): 2, (1, 0): 0, (1, 1): 1}
CLASSES = 8  # the shuffle form's columns (c_out = 1)


def fed(a: int, c: int) -> bool:
    """Whether window offset ``a`` feeds class ``c`` along one axis."""
    return (a, c) in TAP


def slot(off: Sequence[int], cls: Sequence[int]) -> int:
    """The sparse form's slot of window offset ``off`` = (ad, ah, aw) and
    class ``cls`` = (cd, ch, cw) (a fed pair): the pairs in the order of
    (offset, class), each row-major (`csrc/deconv3d_s2.cu:slot`)."""
    (ad, ah, aw), (cd, ch, cw) = off, cls
    return (9 * ad + 3 * (1 + ad) * ah + (1 + ad) * (1 + ah) * aw
            + (cd * (1 + ah) + ch) * (1 + aw) + cw)


def pairs() -> List[Tuple[Tuple[int, int, int], Tuple[int, int, int]]]:
    """The 27 fed (offset, class) pairs, in slot order."""
    return [(off, cls)
            for off in itertools.product((0, 1), repeat=3)
            for cls in itertools.product((0, 1), repeat=3)
            if all(fed(a, c) for a, c in zip(off, cls))]


def taps(off, cls) -> Tuple[int, int, int]:
    """The kernel tap (td, th, tw) of a fed (offset, class) pair."""
    return tuple(TAP[a, c] for a, c in zip(off, cls))


def kernel_weights(w: torch.Tensor,
                   dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """A layer's (C, c_out, 3, 3, 3) weight -> the kernel's form in
    ``dtype`` (exact for a bf16 net's fp32 carrier), contiguous: (27, c_out,
    C), slot `slot` holding the pair's tap transposed; where c_out = 1,
    (8, 8, C), offset-major, the class rows of each offset (zero rows where
    the offset does not feed the class)."""
    if w.shape[1] == 1:
        kt = w.new_zeros((8, CLASSES, w.shape[0]))
        for o, off in enumerate(itertools.product((0, 1), repeat=3)):
            for k, cls in enumerate(itertools.product((0, 1), repeat=3)):
                if all(fed(a, c) for a, c in zip(off, cls)):
                    kt[o, k] = w[(slice(None), 0) + taps(off, cls)]
        return kt.to(dtype).contiguous()
    return torch.stack([w[(slice(None), slice(None)) + taps(off, cls)].T
                        for off, cls in pairs()]).to(dtype).contiguous()


def contract_weights(kt: torch.Tensor) -> torch.Tensor:
    """The inverse of `kernel_weights`: -> (C, c_out, 3, 3, 3),
    contiguous."""
    shuffle = kt.shape[0] == 8
    c_out = 1 if shuffle else kt.shape[1]
    w = kt.new_zeros((kt.shape[2], c_out, 3, 3, 3))
    for off, cls in pairs():
        if shuffle:
            k = 4 * cls[0] + 2 * cls[1] + cls[2]
            wt = kt[4 * off[0] + 2 * off[1] + off[2], k:k + 1]
        else:
            wt = kt[slot(off, cls)]
        w[(slice(None), slice(None)) + taps(off, cls)] = wt.T
    return w.contiguous()


def tile_plan(n: int, d: int, h: int, w: int, c: int,
              c_out: int) -> _c223.TilePlan:
    """The kernel's tiling of y (n, d, h, w, c) for c_out: the shared
    pipeline's plan (`conv223.plan`) of y's N * D planes of H rows, each
    tile staged with one halo row and one halo column (2 taps along H and W
    read from one slab); BN = 8 (the 8 class columns) where c_out = 1, else
    16 where c_out = 16 or C = 128 (so the weights fit in shared memory),
    else 32, and c_out / BN N tiles; tiles of 8 rows where c_out = 1 (4 m64
    blocks a consumer warpgroup), else 2 (1: 8 accumulators); 32-channel
    chunks (64-byte swizzle) for C <= 32, 64-channel ones above (as
    `csrc/deconv3d_s2.cu:DCfg`). A tile's K-steps are (chunk, depth
    offset): 2 a chunk."""
    bn = 8 if c_out == 1 else 16 if c_out == 16 or c == 128 else 32
    return _c223.plan(n * d, h, w, c, CLASSES if c_out == 1 else c_out,
                      bn=bn, taps=2, chunk=32 if c <= 32 else 64,
                      rows=8 if c_out == 1 else 2, halo_cols=1, halo_rows=1)


def grid(plan: _c223.TilePlan, sm_count: int) -> int:
    """Persistent blocks of a launch: each N tile its own set, at most one
    a tile of y and ``sm_count`` in all (a multiple of the N tiles)."""
    spatial = plan.planes * plan.per_plane
    return max(1, min(spatial, sm_count // plan.n_tiles)) * plan.n_tiles


def deconv3d_s2_plain(y: torch.Tensor, kt: torch.Tensor, bias: torch.Tensor,
                      skip: Optional[torch.Tensor],
                      out_spatial: Sequence[int]) -> torch.Tensor:
    """Plain PyTorch version on NDHWC ``y`` (and ``skip``): the model's own
    arithmetic, the round-once transposed conv on fp32 carriers
    (`ops/convolution.py:_conv_transpose`), then the skip add and the ELU
    in y's dtype; differentiable."""
    # imported here: `ops` imports the kernel wrappers
    from redtail_tpu_torch.ops.convolution import _conv_transpose
    out = _conv_transpose(y.permute(0, 4, 1, 2, 3),
                          contract_weights(kt).float(), bias, out_spatial, 2,
                          "SAME")
    if skip is not None:
        out = F.elu(out + skip.permute(0, 4, 1, 2, 3))
    return out.permute(0, 2, 3, 4, 1).contiguous()


def _check(y, kt, bias, skip, out_spatial) -> None:
    """Raises on input no version takes."""
    c_out = bias.shape[0] if bias.dim() == 1 else -1
    want_kt = (8, CLASSES, y.shape[-1]) if c_out == 1 else \
        (27, c_out, y.shape[-1])
    if y.dim() != 5 or tuple(kt.shape) != want_kt:
        raise ValueError(f"y must be (N, D, H, W, C) and kt {want_kt} for a "
                         f"({c_out},) bias; got {tuple(y.shape)} and "
                         f"{tuple(kt.shape)}")
    if y.dtype not in DTYPES or kt.dtype != y.dtype:
        raise TypeError("y and kt must both be float32 or bfloat16; got "
                        f"{y.dtype} and {kt.dtype}")
    if min(y.shape) < 1:
        raise ValueError(f"empty input {tuple(y.shape)}")
    if len(out_spatial) != 3 or any(
            2 * a - x not in (0, 1) for a, x in zip(y.shape[1:4],
                                                   out_spatial)):
        raise ValueError(f"out_spatial {tuple(out_spatial)} is not a TF-SAME "
                         f"stride-2 output for y {tuple(y.shape[1:4])}: each "
                         "input extent must be ceil(out / 2)")
    if skip is not None and (
            tuple(skip.shape) != (y.shape[0], *out_spatial, c_out)
            or skip.dtype != y.dtype):
        raise ValueError(f"skip must be {y.dtype} "
                         f"{(y.shape[0], *out_spatial, c_out)}; got "
                         f"{skip.dtype} {tuple(skip.shape)}")


def _on_cpu(y, kt, bias, skip) -> bool:
    """True where every input is on the CPU; raises on inputs the kernel
    does not take."""
    tensors = [t for t in (y, kt, bias, skip) if t is not None]
    if all(t.device.type == "cpu" for t in tensors):
        return True
    if not (y.is_cuda and all(t.device == y.device for t in tensors)):
        raise ValueError("y, kt, bias and skip must lie on one CUDA device "
                         "(or all on the CPU); got "
                         f"{[str(t.device) for t in tensors]}")
    if y.dtype != torch.bfloat16:
        raise TypeError("the CUDA kernel takes bf16 y and kt (fp32 nets keep "
                        f"cuDNN's transposed conv); got {y.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the CUDA kernel takes contiguous y (N, D, H, W, C), "
                         "kt and skip")
    c, c_out = y.shape[-1], bias.shape[0]
    if c not in CHANNELS or c_out not in OUT_CHANNELS:
        raise ValueError(f"the CUDA kernel takes C in {CHANNELS} and c_out in "
                         f"{OUT_CHANNELS}; got C={c}, c_out={c_out}")
    if (skip is None) != (c_out == 1):
        raise ValueError("the CUDA kernel takes a skip (and applies the ELU) "
                         "where c_out > 1, and neither where c_out = 1; got "
                         f"c_out={c_out} and "
                         f"{'no skip' if skip is None else 'a skip'}")
    return False


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("deconv3d_s2")
    lib.deconv3d_s2_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 14 + [ctypes.c_void_p])
    lib.deconv3d_s2_launch.restype = ctypes.c_int
    lib.deconv3d_s2_error_string.argtypes = [ctypes.c_int]
    lib.deconv3d_s2_error_string.restype = ctypes.c_char_p
    return lib


def _launch(y, kt, bias, skip, out_spatial) -> torch.Tensor:
    n, d, h, w, c = y.shape
    c_out = bias.shape[0]
    b = bias.float().contiguous()
    out = torch.empty((n, *out_spatial, c_out), dtype=y.dtype,
                      device=y.device)
    for t in (y, kt, out) if skip is None else (y, kt, out, skip):
        if t.data_ptr() % 32:
            raise ValueError("tensor storage not aligned to 32 bytes")
    plan = tile_plan(n, d, h, w, c, c_out)
    lib = _lib()
    with on_device(y.device):
        err = lib.deconv3d_s2_launch(
            y.data_ptr(), kt.data_ptr(), b.data_ptr(),
            None if skip is None else skip.data_ptr(), out.data_ptr(), n, d,
            h, w, c, c_out, *out_spatial, plan.bn, plan.chunk,
            plan.edge_rows, grid(plan, _c223._sm_count(y.device.index)),
            y.device.index, torch.cuda.current_stream(y.device).cuda_stream)
    if err:
        raise RuntimeError(
            f"deconv3d_s2 kernel launch failed: CUDA error {err} "
            f"({lib.deconv3d_s2_error_string(err).decode()})")
    deconv3d_s2.launches += 1
    return out


def _forward(y, kt, bias, skip, out_spatial) -> torch.Tensor:
    """One call, the body of the op `redtail_torch::deconv3d_s2`
    (`_ops.py`): the plain version on the CPU, else the kernel (its tile
    plan and SM count taken here, never while tracing), counted on the
    wrapper."""
    out_spatial = [int(v) for v in out_spatial]
    if _on_cpu(y, kt, bias, skip):
        return deconv3d_s2_plain(y, kt, bias, skip, out_spatial)
    return _launch(y, kt, bias, skip, out_spatial)


def deconv3d_s2(y: torch.Tensor, kt: torch.Tensor, bias: torch.Tensor,
                skip: Optional[torch.Tensor],
                out_spatial: Sequence[int]) -> torch.Tensor:
    """(N, Dy, Hy, Wy, C) with kt and (c_out,) bias [+ skip (N, *out_spatial,
    c_out)] -> (N, *out_spatial, c_out), the transposed conv and, with a
    skip, its skip add and ELU (see the module docstring).

    CPU tensors take `deconv3d_s2_plain`. CUDA tensors launch the kernel on
    the current stream and add one to ``deconv3d_s2.launches``; they must be
    bf16, contiguous, on one device, 32-byte aligned, with C in `CHANNELS`,
    c_out in `OUT_CHANNELS`, and a skip exactly where c_out > 1. Both go
    through the custom op `redtail_torch::deconv3d_s2`, except a CPU call
    that needs grad, which runs the differentiable plain version itself."""
    out_spatial = [int(v) for v in out_spatial]
    _check(y, kt, bias, skip, out_spatial)
    if _on_cpu(y, kt, bias, skip):
        if _build.needs_grad(y, kt, bias, skip):
            return deconv3d_s2_plain(y, kt, bias, skip, out_spatial)
    else:
        _build.refuse_autograd("deconv3d_s2", y, kt, bias, skip)
    return torch.ops.redtail_torch.deconv3d_s2(y, kt, bias, skip,
                                               out_spatial)


deconv3d_s2.launches = 0
