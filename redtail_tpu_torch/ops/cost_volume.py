"""Correlation cost volume of the ResNet18-2D model
(`redtail_tpu/ops/cost_volume.py:corr_cost_volume_dlast`).

Slice ``d`` pairs the left feature map with the right one shifted right by
``d`` pixels (``right[x - d]``, zero where ``x < d``). On the card the
volume is the hand-written CUDA kernel (`kernels/corr_cost_volume.py`);
CPU tensors take its plain version.
"""

from __future__ import annotations

import torch

from redtail_tpu_torch.kernels.corr_cost_volume import corr_cost_volume


def corr_cost_volume_dlast(left: torch.Tensor, right: torch.Tensor,
                           max_disp: int) -> torch.Tensor:
    """(N, H, W, C) x2 -> (N, H, W, D) in fp32, disparity last so the
    soft-argmax reduces over the last axis."""
    return corr_cost_volume(left, right, max_disp, layout="dlast")
