"""Stereo cost volumes (`redtail_tpu/ops/cost_volume.py`): the concat
volume of the 3D models and the correlation volume of ResNet18-2D.

Slice ``d`` pairs the left feature map with the right one shifted right by
``d`` pixels (``right[x - d]``, zero where ``x < d``). On the card each
volume is a hand-written CUDA kernel (`kernels/cost_volume_concat.py`,
`kernels/corr_cost_volume.py`, whose fused epilogue also gives the
soft-argmax of the correlation volume without the volume); CPU tensors take
their plain versions.
"""

from __future__ import annotations

import torch

from redtail_tpu_torch.kernels.corr_cost_volume import (
    corr_cost_volume,
    corr_softargmax,
)
from redtail_tpu_torch.kernels.cost_volume_concat import cost_volume_concat


def cost_volume(left: torch.Tensor, right: torch.Tensor, max_disp: int, *,
                d_offset: int = 0, d_count=None) -> torch.Tensor:
    """Concat volume: (N, H, W, C) x2 -> (N, D, H, W, 2C) in the input
    dtype; channels [0, C) are the left map tiled over D, [C, 2C) the
    shifted right map. ``d_offset`` / ``d_count``: only that block of
    disparities (disparity sharding)."""
    return cost_volume_concat(left, right, max_disp, d_offset=d_offset,
                              d_count=d_count)


def corr_cost_volume_dlast(left: torch.Tensor, right: torch.Tensor,
                           max_disp: int) -> torch.Tensor:
    """(N, H, W, C) x2 -> (N, H, W, D) in fp32, disparity last so the
    soft-argmax reduces over the last axis."""
    return corr_cost_volume(left, right, max_disp, layout="dlast")


def corr_softargmax_dlast(left: torch.Tensor, right: torch.Tensor,
                          max_disp: int) -> torch.Tensor:
    """(N, H, W, C) x2 -> (N, H, W) fp32: ``softargmax(
    corr_cost_volume_dlast(left, right, max_disp), axis=-1)``, in one
    kernel on the card."""
    return corr_softargmax(left, right, max_disp)
