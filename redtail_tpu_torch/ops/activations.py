"""Activations of the ResNet18-2D path (`redtail_tpu/ops/activations.py`).

- ``elu``: the reference's `EluPlugin` (cuDNN ELU, alpha 1).
- ``sigmoid``: ResNet18-2D's output head, disparity normalized to [0, 1].

TrailNet's ``srelu`` comes with the TrailNet slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def elu(x: torch.Tensor) -> torch.Tensor:
    return F.elu(x)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x)
