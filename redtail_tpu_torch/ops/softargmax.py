"""Soft-argmax / soft-argmin over one axis (`redtail_tpu/ops/softargmax.py`).

The softmax runs in fp32 whatever the input dtype, and the result is cast
back to the input dtype, as in the JAX package. Plain PyTorch: in JAX this
is XLA, not a Pallas kernel.

Inside `ops.halo.sharded_axis` over the reduced axis (disparity
sharding), each rank holds its disparities of the global axis: the
normalization is the one cross-rank step, an ``all_reduce(MAX)`` of the
local maxima and one ``all_reduce(SUM)`` of the local sums of exp and of
d * exp at the global disparity indices. Inference only (the collectives
carry no gradient).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from redtail_tpu_torch.ops.halo import current_sharding


def softargmax(x: torch.Tensor, *, axis: int = 1,
               scale: float = 1.0) -> torch.Tensor:
    """sum(softmax(scale * x, axis) * arange(D)); removes ``axis``."""
    sh = current_sharding()
    if sh is not None and axis % x.dim() == x.dim() + sh.axis:
        return _sharded_softargmax(x, axis % x.dim(), scale, sh)
    d = x.shape[axis]
    prob = torch.softmax(x.float() * scale, dim=axis)
    idx_shape = [1] * x.dim()
    idx_shape[axis] = d
    idx = torch.arange(d, dtype=torch.float32, device=x.device)
    return (prob * idx.reshape(idx_shape)).sum(axis).to(x.dtype)


def softargmin(x: torch.Tensor, *, axis: int = 1) -> torch.Tensor:
    """Soft-argmin: the soft-argmax of the negated input."""
    return softargmax(x, axis=axis, scale=-1.0)


def _sharded_softargmax(x, axis, scale, sh) -> torch.Tensor:
    """`softargmax` over an axis whose global rows the ranks of
    ``sh.group`` share (this rank's are ``sh.owned()``)."""
    lo, hi = sh.owned()
    if x.shape[axis] != hi - lo:
        raise ValueError(f"rank {sh.index} holds {x.shape[axis]} rows of "
                         f"axis {axis}, owns {hi - lo} of {sh.global_size}")
    z = x.float() * scale
    shape = list(z.shape)
    del shape[axis]
    top = (z.amax(dim=axis) if hi > lo
           else z.new_full(shape, float("-inf")))
    dist.all_reduce(top, op=dist.ReduceOp.MAX, group=sh.group)
    e = torch.exp(z - top.unsqueeze(axis))
    idx_shape = [1] * x.dim()
    idx_shape[axis] = hi - lo
    idx = torch.arange(lo, hi, dtype=torch.float32,
                       device=x.device).reshape(idx_shape)
    sums = torch.stack([e.sum(axis), (e * idx).sum(axis)])
    dist.all_reduce(sums, group=sh.group)
    return (sums[1] / sums[0]).to(x.dtype)
