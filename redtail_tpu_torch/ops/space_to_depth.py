"""Space-to-depth packing for the 5x5 stride-2 stem
(`redtail_tpu/ops/space_to_depth.py`).

Packing 2x2 pixel blocks into channels (3 -> 12) turns conv1 into an
exactly equivalent 3x3 stride-1 conv over the packed image. The serving
node packs frames on the host (`space_to_depth2_np`, or the native
runtime's pack) and the model loads the stem's 3x3 form once
(`conv5s2_kernel_to_s2d`). `space_to_depth2` is the same pack of a tensor
on its device, in the JAX package's three forms; `use_s2d_stem` is its
switch, ``REDTAIL_TPU_S2D`` (on unless ``0``: the port's nodes always fed
s2d frames to a float stem).

Kernel algebra (per axis; TF-SAME, k=5, s=2, pad_begin p0): output i reads
original rows 2i - p0 + dy, dy in [0, 5); packed row i + t, phase q holds
original row 2(i + t) + q, so k3[t + 1, q] = w5[2t + q + p0] with
out-of-range taps zero. p0 is 2 for odd sizes and 1 for even ones, so the
remap depends on the parity of the ORIGINAL H and W.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from redtail_tpu_torch.ops.convolution import _conv_sum, tf_same_padding

S2D_IMPLS = ("slices", "reshape", "conv")


def s2d_hw(hw: Tuple[int, int]) -> Tuple[int, int]:
    """Packed spatial size for an original (H, W)."""
    return -(-hw[0] // 2), -(-hw[1] // 2)


def space_to_depth2_np(x: np.ndarray) -> np.ndarray:
    """(..., H, W, C) -> (..., ceil(H/2), ceil(W/2), 4C), phase-major
    channels: out[..., (2*py + px)*C + c] = x[..., 2i + py, 2j + px, c];
    odd H/W are zero-padded at the end (conv1's TF-SAME zero rows)."""
    h, w = x.shape[-3:-1]
    hp, wp = s2d_hw((h, w))
    pad = [(0, 0)] * (x.ndim - 3) + [(0, 2 * hp - h), (0, 2 * wp - w),
                                     (0, 0)]
    xp = np.pad(x, pad)
    return np.concatenate([xp[..., py::2, px::2, :]
                           for py in (0, 1) for px in (0, 1)], axis=-1)


def space_to_depth2(x: torch.Tensor, *, impl: str = "slices"
                    ) -> torch.Tensor:
    """(N, H, W, C) tensor -> (N, ceil(H/2), ceil(W/2), 4C) on its device,
    the channels phase-major as `space_to_depth2_np`'s, odd H/W
    zero-padded at the end. ``impl``: ``"slices"`` (four strided slices
    and a concat), ``"reshape"`` (a 6D reshape and permute) or ``"conv"``
    (an identity-weight k=2 stride-2 conv on fp32 carriers, rounded back
    to x's dtype: exact). Every form gives the same bits."""
    if impl not in S2D_IMPLS:
        raise ValueError(f"impl must be one of {S2D_IMPLS}, got {impl!r}")
    n, h, w, c = x.shape
    hp, wp = s2d_hw((h, w))
    if impl == "conv":
        k = torch.zeros(4 * c, c, 2, 2, dtype=torch.float32,
                        device=x.device)
        for py in (0, 1):
            for px in (0, 1):
                k[(2 * py + px) * c + torch.arange(c), torch.arange(c),
                  py, px] = 1.0
        xc = F.pad(x.permute(0, 3, 1, 2), [0, 2 * wp - w, 0, 2 * hp - h])
        return _conv_sum(xc, k, 2, 0).to(x.dtype).permute(0, 2, 3, 1)
    xp = F.pad(x, [0, 0, 0, 2 * wp - w, 0, 2 * hp - h])
    if impl == "reshape":
        return xp.reshape(n, hp, 2, wp, 2, c).permute(0, 1, 3, 2, 4, 5) \
            .reshape(n, hp, wp, 4 * c)
    return torch.cat([xp[:, py::2, px::2] for py in (0, 1) for px in (0, 1)],
                     dim=-1)


def use_s2d_stem() -> bool:
    """Whether float stems take s2d-packed frames (the serving nodes pack
    them on the host): on unless ``REDTAIL_TPU_S2D=0``. The JAX package
    turns it on by default on a TPU; the port's nodes always fed the card
    s2d frames."""
    return os.environ.get("REDTAIL_TPU_S2D") != "0"


def conv5s2_kernel_to_s2d(w5: np.ndarray,
                          in_hw: Tuple[int, int]) -> np.ndarray:
    """(5, 5, Ci, Co) stride-2 TF-SAME kernel -> the equivalent
    (3, 3, 4*Ci, Co) stride-1 kernel over `space_to_depth2_np` input.

    ``in_hw`` is the ORIGINAL image size; its parity fixes the pad."""
    p0h = tf_same_padding(in_hw[0], 5, 2)[0]
    p0w = tf_same_padding(in_hw[1], 5, 2)[0]
    ci, co = w5.shape[2], w5.shape[3]
    # Pad the tap range to [-1, 6) so out-of-range taps index a zero row.
    wpad = np.pad(w5, ((1, 1), (1, 1), (0, 0), (0, 0)))
    dy = np.array([[2 * t + q + p0h - 1 for q in (0, 1)] for t in range(3)])
    dx = np.array([[2 * t + q + p0w - 1 for q in (0, 1)] for t in range(3)])
    k = wpad[dy.reshape(-1)][:, dx.reshape(-1)]    # (6, 6, ci, co)
    k = k.reshape(3, 2, 3, 2, ci, co)              # (ty, py, tx, px, ci, co)
    return k.transpose(0, 2, 1, 3, 4, 5).reshape(3, 3, 4 * ci, co)
