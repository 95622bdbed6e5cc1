"""Activations of the model zoo (`redtail_tpu/ops/activations.py`).

- ``elu``: the reference's `EluPlugin` (cuDNN ELU, alpha 1).
- ``srelu``: TrailNet's "shifted ReLU", the Scale(+1) -> ReLU -> Scale(-1)
  triplet of its prototxt: relu(x + 1) - 1, each step rounded in the input
  dtype as the JAX function rounds it (in bf16, ``x + 1`` rounds), so it is
  not ``clamp(x, min=-1)``.
- ``sigmoid``: ResNet18-2D's output head, disparity normalized to [0, 1].
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def elu(x: torch.Tensor) -> torch.Tensor:
    return F.elu(x)


def srelu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x + 1) - 1


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x)
