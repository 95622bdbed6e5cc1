"""Soft-argmax / soft-argmin over one axis (`redtail_tpu/ops/softargmax.py`).

The softmax runs in fp32 whatever the input dtype, and the result is cast
back to the input dtype, as in the JAX package. Plain PyTorch: in JAX this
is XLA, not a Pallas kernel.
"""

from __future__ import annotations

import torch


def softargmax(x: torch.Tensor, *, axis: int = 1,
               scale: float = 1.0) -> torch.Tensor:
    """sum(softmax(scale * x, axis) * arange(D)); removes ``axis``."""
    d = x.shape[axis]
    prob = torch.softmax(x.float() * scale, dim=axis)
    idx_shape = [1] * x.dim()
    idx_shape[axis] = d
    idx = torch.arange(d, dtype=torch.float32, device=x.device)
    return (prob * idx.reshape(idx_shape)).sum(axis).to(x.dtype)


def softargmin(x: torch.Tensor, *, axis: int = 1) -> torch.Tensor:
    """Soft-argmin: the soft-argmax of the negated input."""
    return softargmax(x, axis=axis, scale=-1.0)
