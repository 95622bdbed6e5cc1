"""Space-to-depth packing for the 5x5 stride-2 stem
(`redtail_tpu/ops/space_to_depth.py`), in numpy.

Packing 2x2 pixel blocks into channels (3 -> 12) turns conv1 into an
exactly equivalent 3x3 stride-1 conv over the packed image. The serving
node packs frames on the host (`space_to_depth2_np`) and the model loads
the stem's 3x3 form once (`conv5s2_kernel_to_s2d`).

Kernel algebra (per axis; TF-SAME, k=5, s=2, pad_begin p0): output i reads
original rows 2i - p0 + dy, dy in [0, 5); packed row i + t, phase q holds
original row 2(i + t) + q, so k3[t + 1, q] = w5[2t + q + p0] with
out-of-range taps zero. p0 is 2 for odd sizes and 1 for even ones, so the
remap depends on the parity of the ORIGINAL H and W.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from redtail_tpu_torch.ops.convolution import tf_same_padding


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
