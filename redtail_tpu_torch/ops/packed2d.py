"""H-packed 2D convolutions (`redtail_tpu/ops/packed2d.py`): row pairs
folded into channels.

The 1-axis form of `ops/packed3d.py`'s band algebra, which the JAX
package uses for ResNet-18's towers on a TPU (block-diagonal 64-channel
convs run at 128 channels, for 4/3 of the dense FLOPs: kh 3 -> 2 taps x 2
parities). No model path of the port calls these ops: its towers run as
one batch of 2N, which beat this layout on the H100. They are held against
the JAX package op by op (`tests/test_torch_packed2d.py`, each against its
JAX twin; `tests/test_torch_sharding_hpacked.py` on each rank's slots).
Every op is exact against its unpacked counterpart.

- **Layouts.** *Aligned*: slot b, parity q holds row 2b + q (ceil(h/2)
  slots); *shifted*: slot a, parity r holds row 2a - 1 + r (one slot more,
  out-of-image rows zero). Channels are (parity, c).
- **Stride-1 k=3 TF-SAME convs** consume one convention and emit the other
  at kh=2 slot taps with the band t = 2 ws + q_in - r_out (`_A_FLIP`;
  only the padding differs), so resblock chains alternate and their skip
  adds line up aligned. `conv2d_hpacked_keep` stays aligned at kh=3
  (`_A_KEEP`, t = 2 ws + q_in - r_out - 1).
- **The s2d stem** (`conv1_s2d_hpacked`) is one kh=4 stride-(2, 1) conv
  whose output channels carry the row parity, so the pack costs nothing at
  ingest.
- **Unpack** (`unpack_h2d`): a reshape and permute here, which computes
  what the JAX package's identity-weight lhs-dilated conv computes.
- **Correlation** rows are independent, so the JAX package's H-packed
  head reads the packed features per parity group: `corr_softargmax_hpacked` is the corr
  kernel's grouped soft-argmax (`kernels/corr_cost_volume.py`, one launch
  on the card); `corr_cost_volume_hpacked` and `softargmax_hpacked` are the
  JAX functions, the plain version of that launch.

Each conv is one cuDNN conv on fp32 carriers through `ops/convolution.py`
(TF32 off for fp32, allowed for bf16, exact in its products); its fp32 sum
takes the bias and the activation in fp32 and is rounded once, as JAX's
packed ops do. Pad rows are re-zeroed **after** bias and activation (elu of
a bias in a pad row would corrupt every consumer's band algebra), in place.
Each op takes the JAX function's arguments (NHWC activations, HWIO
weights) and, as ``kernel=``, optionally its packed kernel already in
`F.conv2d`'s layout (`prepare`), derived once by the caller.

**Image sharding.** Inside an image `ops.halo.sharded_axis` each op runs
on this rank's slots of axis 1 (`ops/packed3d.py`'s rule on axis 2): a
conv owns its output slots under the ownership rule over the output's
global slot count and fetches its input's halo slots (`halo_rows` over
the input's global count: the stem's ``h_half`` s2d rows, ``ceil(h /
2)`` aligned slots, one more shifted); a pad row is zeroed only on the
rank that holds its global slot; `unpack_h2d` returns this rank's own
rows of ``h`` from the slots that hold them (one `fetch`); the grouped
corr is row-local and reads no halo. A rank that owns nothing still
joins every exchange and returns `empty_shard`. The global sizes follow
from ``h`` and the layout, never from the shard's shape.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from redtail_tpu_torch.ops.convolution import _conv_sum
from redtail_tpu_torch.ops.halo import (empty_shard, fetch, halo_rows,
                                       image_sharding, window_size)


def _band(table: Callable[[int, int, int], int], n_ws: int) -> np.ndarray:
    """A[ws, q, r, t] from a callable t(ws, q, r); out-of-range taps 0."""
    A = np.zeros((n_ws, 2, 2, 3), np.float32)
    for ws in range(n_ws):
        for q in range(2):
            for r in range(2):
                t = table(ws, q, r)
                if 0 <= t <= 2:
                    A[ws, q, r, t] = 1.0
    return A


_A_FLIP = _band(lambda ws, q, r: 2 * ws + q - r, 2)       # aligned<->shifted
_A_KEEP = _band(lambda ws, q, r: 2 * ws + q - r - 1, 3)   # aligned->aligned


def _k_packed(w: torch.Tensor, A: np.ndarray) -> torch.Tensor:
    """(3, 3, Ci, Co) + band A -> (Ws, 3, 2 Ci, 2 Co) HWIO, channel groups
    (parity, c) on both sides. Every entry is one weight or zero."""
    k = torch.einsum("wqrt,txio->wxqiro",
                     torch.from_numpy(A).to(w.device), w.float())
    ws, kx, _, ci, _, co = k.shape
    return k.reshape(ws, kx, 2 * ci, 2 * co).to(w.dtype)


def flip_kernel(w: torch.Tensor) -> torch.Tensor:
    """`conv2d_hpacked`'s HWIO kernel (2, 3, 2 Ci, 2 Co)."""
    return _k_packed(w, _A_FLIP)


def keep_kernel(w: torch.Tensor) -> torch.Tensor:
    """`conv2d_hpacked_keep`'s HWIO kernel (3, 3, 2 Ci, 2 Co)."""
    return _k_packed(w, _A_KEEP)


def stem_kernel(k3: torch.Tensor) -> torch.Tensor:
    """`conv1_s2d_hpacked`'s HWIO kernel (4, 3, Ci, 2 Co): K[kr, :, :, (q',
    co)] = k3[kr - q'] (zero out of range)."""
    z = torch.zeros_like(k3[0])
    taps = [k3[kr - q] if 0 <= kr - q <= 2 else z
            for kr in range(4) for q in (0, 1)]
    k4 = torch.stack(taps).reshape(4, 2, *k3.shape[1:])  # (kr, q, x, ci, co)
    return k4.permute(0, 2, 3, 1, 4).reshape(4, k3.shape[1], k3.shape[2],
                                             2 * k3.shape[3])


def prepare(k: torch.Tensor) -> torch.Tensor:
    """An HWIO kernel as `F.conv2d`'s (O, I, kh, kw), channels-last."""
    return k.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)


def slots(h: int, shifted: bool = False) -> int:
    """The global slot count of an H-packed axis of ``h`` original rows:
    ``ceil(h / 2)`` aligned, one more shifted."""
    return -(-h // 2) + int(shifted)


def _conv(x: torch.Tensor, kernel: torch.Tensor, stride, pads, *,
          rows: int) -> torch.Tensor:
    """The fp32 sum of NHWC ``x`` convolved with the OIHW ``kernel`` at
    window ``stride`` and per-axis (lo, hi) ``pads``, NHWC. ``rows``: the
    global size of axis 1 (slots, or the stem's s2d rows); inside an image
    `sharded_axis` the conv returns this rank's slots of its output
    (`halo_rows`)."""
    sh = image_sharding()
    if sh is not None:
        pads = list(pads)
        x, pads[0], (a, b) = halo_rows(x, sh, 1, global_size=rows,
                                       k=kernel.shape[2], s=stride[0],
                                       pads=pads[0])
        if b == a:
            return empty_shard(x, (x.shape[0], 0, window_size(
                x.shape[2], kernel.shape[3], stride[1], pads[1]),
                kernel.shape[0]), torch.float32)
    xc = x.permute(0, 3, 1, 2)
    if all(lo == hi for lo, hi in pads):
        pad = tuple(lo for lo, _ in pads)
    else:
        xc = F.pad(xc, [p for pair in reversed(pads) for p in pair])
        pad = 0
    return _conv_sum(xc, kernel, stride, pad).permute(0, 2, 3, 1)


def _finish(out: torch.Tensor, b: Optional[torch.Tensor], act, dtype,
            h: int, shifted: bool, blocks: int = 1) -> torch.Tensor:
    """Bias and ``act`` in fp32, one cast to ``dtype``, then the pad rows
    zeroed. ``b``: (Co,), tiled over the two parities, or the output's
    full width in its channel order."""
    if b is not None:
        out = out + (b.float() if b.numel() == out.shape[-1]
                     else b.float().repeat(2))
    if act is not None:
        out = act(out)
    return _mask_rows(out.to(dtype), h, shifted=shifted, blocks=blocks)


def _mask_rows(y: torch.Tensor, h: int, *, shifted: bool,
               blocks: int = 1) -> torch.Tensor:
    """Zero, in place, the parity channels whose original row 2 slot + q
    (minus 1 if ``shifted``) falls outside [0, h): global slot 0 and the
    last two are the only ones that can hold one. Inside an image
    `sharded_axis` each is zeroed only on the rank that holds it (a local
    index would zero a real interior slot). The channels are ``blocks``
    blocks of (parity, c)."""
    sh = image_sharding()
    n_slots = y.shape[1] if sh is None else slots(h, shifted)
    first = 0 if sh is None else sh.owned(n_slots)[0]
    view = y.unflatten(-1, (blocks, 2, y.shape[-1] // (2 * blocks)))
    for slot in sorted({0, max(n_slots - 2, 0), n_slots - 1}):
        if not first <= slot < first + y.shape[1]:
            continue
        for q in (0, 1):
            row = 2 * slot + q - (1 if shifted else 0)
            if not 0 <= row < h:
                view[:, slot - first, :, :, q] = 0
    return y


def conv1_s2d_hpacked(x_s2d: torch.Tensor, k3: Optional[torch.Tensor],
                      b: Optional[torch.Tensor] = None, *, h_half: int,
                      act=None, kernel: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """The s2d 3x3 stem emitting H-packed ALIGNED output directly.

    x_s2d: (N, H', W', 4 Craw) s2d frames (H' = ceil(H / 2) = ``h_half``,
    the stem's output rows); ``k3``: the `conv5s2_kernel_to_s2d` kernel
    (3, 3, 4 Craw, Co), block-diagonal for the fused towers. Output slot
    b, parity q' = stem output row 2b + q', one kh=4 stride-(2, 1) conv."""
    if kernel is None:
        kernel = prepare(stem_kernel(k3.to(x_s2d.dtype)))
    out = _conv(x_s2d, kernel, (2, 1), [(1, 2), (1, 1)], rows=h_half)
    return _finish(out, b, act, x_s2d.dtype, h_half, shifted=False)


def conv2d_hpacked(x: torch.Tensor, w: Optional[torch.Tensor],
                   b: Optional[torch.Tensor] = None, *, h: int,
                   in_shifted: bool, act=None,
                   kernel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stride-1 3x3 TF-SAME conv on H-packed input, flipping the pair
    convention (aligned in -> shifted out and back; kh=2 taps)."""
    if kernel is None:
        kernel = prepare(flip_kernel(w.to(x.dtype)))
    pad_h = (0, 0) if in_shifted else (1, 1)
    out = _conv(x, kernel, (1, 1), [pad_h, (1, 1)],
                rows=slots(h, in_shifted))
    return _finish(out, b, act, x.dtype, h, shifted=not in_shifted)


def conv2d_hpacked_keep(x: torch.Tensor, w: Optional[torch.Tensor],
                        b: Optional[torch.Tensor] = None, *, h: int,
                        act=None, kernel: Optional[torch.Tensor] = None,
                        blocks: int = 1) -> torch.Tensor:
    """Stride-1 3x3 TF-SAME conv, aligned in -> ALIGNED out (kh=3 slot
    taps, 2x the dense FLOPs: where the layout must not flip, the towers'
    last conv). ``blocks``: a ``kernel`` whose output channels are that
    many blocks of (parity, c) (``b`` then at the output's full width):
    the model's (tower, parity, f) map for the H-packed head, whose tower
    halves the corr kernel reads where they lie."""
    if kernel is None:
        kernel = prepare(keep_kernel(w.to(x.dtype)))
    out = _conv(x, kernel, (1, 1), [(1, 1), (1, 1)], rows=slots(h))
    return _finish(out, b, act, x.dtype, h, shifted=False, blocks=blocks)


def row_slots(xp: torch.Tensor, h: int
              ) -> Tuple[torch.Tensor, int, int]:
    """The aligned slots that hold this rank's rows of ``h``: inside an
    image `sharded_axis` its rows under the ownership rule, from one
    `fetch` of the slots they lie in; else ``xp`` and every row. Returns
    (the slots, the unpacked slab's row of its first row, its row
    count)."""
    sh = image_sharding()
    if sh is None:
        return xp, 0, h
    xp, (a, b), (s0, _) = fetch(
        xp, sh, 1, global_size=slots(h), out_size=h,
        need=lambda a, b: (a // 2, (b - 1) // 2 + 1))
    return xp, (a - 2 * s0 if b > a else 0), b - a


def unpack_h2d(xp: torch.Tensor, h: int) -> torch.Tensor:
    """Aligned H-packed (N, hp, W, 2C) -> (N, h, W, C); inside an image
    `sharded_axis` this rank's own rows of ``h`` (`row_slots`)."""
    xp, lo, n_rows = row_slots(xp, h)
    n, hp, w, c2 = xp.shape
    return xp.reshape(n, hp, w, 2, c2 // 2).permute(0, 1, 3, 2, 4) \
        .reshape(n, 2 * hp, w, c2 // 2).narrow(1, lo, n_rows)


def corr_cost_volume_hpacked(left_p: torch.Tensor, right_p: torch.Tensor,
                             max_disp: int) -> torch.Tensor:
    """Correlation volume on H-packed ALIGNED features, disparity last:
    (N, hp, W, (q, C)) x2 -> (N, hp, W, (q, D)) in fp32, each parity
    group's channel sum taken apart (rows are independent)."""
    n, hp, w, c2 = left_p.shape
    lf = left_p.float().reshape(n, hp, w, 2, c2 // 2)
    rf = right_p.float().reshape(n, hp, w, 2, c2 // 2)
    vol = lf.new_zeros((n, hp, w, 2, max_disp))
    for d in range(min(max_disp, w)):
        vol[:, :, d:, :, d] = (lf[:, :, d:] * rf[:, :, :w - d]).sum(-1)
    return vol.reshape(n, hp, w, 2 * max_disp)


def softargmax_hpacked(vol_p: torch.Tensor, h: int, *,
                       scale: float = 1.0) -> torch.Tensor:
    """Per-parity-group soft-argmax over D of an H-packed (q, D) volume ->
    (N, hp, W, 2), the pad rows re-zeroed (the soft-argmax of an all-zero
    row is the mean index, not 0)."""
    from redtail_tpu_torch.ops.softargmax import softargmax

    n, hp, w, d2 = vol_p.shape
    out = softargmax(vol_p.reshape(n, hp, w, 2, d2 // 2), axis=-1) * scale
    return _mask_rows(out, h, shifted=False)


def corr_softargmax_hpacked(left_p: torch.Tensor, right_p: torch.Tensor,
                            max_disp: int, h: int) -> torch.Tensor:
    """`softargmax_hpacked(corr_cost_volume_hpacked(...), h)` as the corr
    kernel's grouped soft-argmax: one launch on the card, the packed
    features read where they lie (channel slices of one map allowed), no
    volume in memory; its plain version on the CPU. -> (N, hp, W, 2)
    fp32. Rows are independent: inside an image `sharded_axis` each rank
    launches on its own slots, its pad rows counted from its first slot,
    and a rank with none launches nothing."""
    from redtail_tpu_torch.kernels.corr_cost_volume import corr_softargmax

    if left_p.shape[1] == 0:
        return empty_shard(left_p, (left_p.shape[0], 0, left_p.shape[2], 2),
                           torch.float32)
    sh = image_sharding()
    first = 0 if sh is None else sh.owned(slots(h))[0]
    return corr_softargmax(left_p, right_p, max_disp, groups=2,
                           rows=h - 2 * first)
