"""The stereo train step (`redtail_tpu/parallel/training.py`).

One step: the fp32 master weights cast to the compute dtype inside the
graph (`models/stereo.py:_Weights`), the forward under `plain_lowering()`
(the explicit volumes, as the JAX package trains: the concat kernel for the
3D models, the correlation kernel's fused soft-argmax for ResNet18-2D, each
with its backward kernel), the correlation model's [0, 1] output scaled to
pixels by the input width, the smooth-L1 loss over the valid pixels, the
backward, one optimizer update. The three phases are trace spans
(`runtime/profiler.py:span`): ``train/forward`` (the forward and the loss),
``train/backward`` (the gradients zeroed, the backward, the remat
recompute in it) and ``train/optimizer`` (the update).

``remat`` mirrors `jax.checkpoint(policy=nothing_saveable)`: the forward
runs under `torch.utils.checkpoint` (non-reentrant) and is recomputed in
the backward. The kernels' and convs' autograd functions are deterministic,
so the recompute gives the same bits and the grads equal those without
remat.

Optimizers: `OptimizerSpec` stands where the JAX step takes an optax
transformation: Adam, AdamW or SGD with momentum, the learning rate a
constant or a schedule of the update count read before the count
increments (optax's rule: the first update of a warmup schedule has lr 0),
applied through a `LambdaLR` over a base rate of 1.

Over a mesh (``mesh``, `parallel/sharding.py:make_mesh`) each rank takes
its shard of the global batch: N over ``data`` and H over ``spatial``, the
target and the valid mask (N, H, W) sharded the same way, the params and
the optimizer state replicated. The loss is the global masked mean: the
local sum of loss * mask over the ``all_reduce``d count of valid pixels
(so ranks with different valid counts weigh each pixel alike, where a mean
of per-rank means would not). The spatial shards exchange conv halos
(`ops/halo.py:sharded_axis`) and hold partial gradients of the same
weights, so every gradient is summed over the whole mesh, both axes, with
one ``all_reduce`` of the flattened gradients; every rank then takes the
same update, and the params stay bit-equal across ranks. The metrics are
global too.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional, Tuple, Union

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from redtail_tpu_torch import resolve_device
from redtail_tpu_torch.models.stereo import (StereoNet, StereoSpec,
                                             params_from_numpy)
from redtail_tpu_torch.ops.convolution import plain_lowering
from redtail_tpu_torch.ops.halo import IMAGE_AXIS, sharded_axis
from redtail_tpu_torch.parallel.sharding import (SPATIAL_AXIS, batch_sharding,
                                                 check_batch, local_shard)
from redtail_tpu_torch.runtime.profiler import span

Schedule = Callable[[int], float]
# per parameter, the optimizer's state entries in the order they are saved
STATE_KEYS = {"adam": ("exp_avg", "exp_avg_sq", "step"),
              "adamw": ("exp_avg", "exp_avg_sq", "step"),
              "sgd": ("momentum_buffer",)}


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    """A torch optimizer as optax describes one: ``name`` ('adam', 'adamw'
    or 'sgd'), ``lr`` a constant or a schedule of the update count, and
    ``weight_decay`` (AdamW) or ``momentum`` (SGD). Adam's betas and eps
    are optax's defaults, which are torch's."""

    name: str
    lr: Union[float, Schedule]
    weight_decay: float = 0.0
    momentum: float = 0.0

    def __post_init__(self):
        if self.name not in STATE_KEYS:
            raise ValueError(f"optimizer must be one of {sorted(STATE_KEYS)},"
                             f" got {self.name!r}")

    def build(self, params, step: int = 0):
        """(optimizer, LambdaLR or None) over ``params``, the schedule
        positioned at update count ``step``."""
        params = list(params)
        scheduled = callable(self.lr)
        lr = 1.0 if scheduled else float(self.lr)
        if self.name == "adam":
            opt = torch.optim.Adam(params, lr=lr)
        elif self.name == "adamw":
            opt = torch.optim.AdamW(params, lr=lr,
                                    weight_decay=self.weight_decay)
        else:
            opt = torch.optim.SGD(params, lr=lr, momentum=self.momentum)
        if not scheduled:
            return opt, None
        for group in opt.param_groups:
            group["initial_lr"] = 1.0
        return opt, torch.optim.lr_scheduler.LambdaLR(
            opt, self.lr, last_epoch=step - 1)


@dataclasses.dataclass
class TrainState:
    """``params``: the trainable `StereoNet` (fp32 masters);
    ``opt_state``: its torch optimizer; ``step``: updates taken;
    ``schedule``: the optimizer's `LambdaLR` (None for a constant rate);
    ``optimizer``: the spec that built them."""

    params: torch.nn.Module
    opt_state: torch.optim.Optimizer
    step: int
    schedule: Optional[torch.optim.lr_scheduler.LambdaLR]
    optimizer: OptimizerSpec


def apply_update(state, loss: torch.Tensor) -> None:
    """Backward of ``loss`` and one optimizer update of ``state`` (the
    gradients zeroed first), the schedule advanced."""
    backward(state, loss)
    optimizer_step(state)


def backward(state, loss: torch.Tensor) -> None:
    """The gradients of ``loss`` into ``state``'s params, zeroed first."""
    with span("train/backward"):
        state.opt_state.zero_grad(set_to_none=True)
        loss.backward()


def optimizer_step(state) -> None:
    """One optimizer update of ``state`` from the gradients its params
    hold, the schedule advanced."""
    with span("train/optimizer"):
        state.opt_state.step()
        if state.schedule is not None:
            state.schedule.step()
        state.step += 1


def _smooth_l1(pred, target, delta: float) -> torch.Tensor:
    """The per-pixel Huber / smooth-L1 terms in fp32."""
    err = pred.float() - target.float()
    abs_err = err.abs()
    return torch.where(abs_err < delta, 0.5 * err * err / delta,
                       abs_err - 0.5 * delta)


def smooth_l1_disparity_loss(pred, target, mask=None, delta: float = 1.0):
    """Huber / smooth-L1 on disparity maps in fp32, the masked mean (mask =
    valid pixels)."""
    loss = _smooth_l1(pred, target, delta)
    if mask is None:
        return loss.mean()
    mask = mask.float()
    return (loss * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def _as_tensor(a, device, dtype) -> torch.Tensor:
    return torch.as_tensor(a).to(device=device, dtype=dtype)


def stereo_train_forward(spec: StereoSpec, net: StereoNet, left, right,
                         shard: Optional[Tuple[object, int]] = None):
    """The forward the step differentiates: the net under
    `plain_lowering()`, the correlation model's output in pixels. With
    ``shard`` = (group, global rows), the rows of ``left`` / ``right`` are
    this rank's shard of H among ``group``'s ranks (entered here, so the
    recompute under remat shards the same way)."""
    with plain_lowering(), (contextlib.nullcontext() if shard is None
                            else sharded_axis(shard[0], IMAGE_AXIS,
                                              shard[1])):
        pred = net(left, right)
    if spec.corr:
        # the correlation head is a sigmoid of the input width's fraction
        # (`main.cpp:325-327`): pixels, as the 3D models' output
        pred = pred * spec.input_hw[1]
    return pred


def _prediction(spec: StereoSpec, net: StereoNet, left, right, *,
                remat: bool, shard=None) -> torch.Tensor:
    """The train forward on ``net``'s device, the images cast to its
    compute dtype, recomputed in the backward with ``remat``. A sharded
    recompute runs to its end (no early stop), so every rank makes the
    same exchanges in it."""
    device, dtype = net.device, net.dtype
    left = _as_tensor(left, device, dtype)
    right = _as_tensor(right, device, dtype)
    if not remat:
        return stereo_train_forward(spec, net, left, right, shard)
    with (contextlib.nullcontext() if shard is None
          else set_checkpoint_early_stop(False)):
        return checkpoint(stereo_train_forward, spec, net, left, right,
                          shard, use_reentrant=False)


def stereo_loss(spec: StereoSpec, net: StereoNet, left, right, target,
                valid, *, remat: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, prediction) of one batch on ``net``'s device: the images cast
    to its compute dtype, the forward recomputed in the backward with
    ``remat``."""
    with span("train/forward"):
        target = _as_tensor(target, net.device, torch.float32)
        valid = _as_tensor(valid, net.device, torch.float32)
        pred = _prediction(spec, net, left, right, remat=remat)
        return smooth_l1_disparity_loss(pred, target, valid), pred


def all_reduce_grads(params, group=None) -> None:
    """Sum every parameter's gradient over ``group`` (default: every rank)
    with one ``all_reduce`` of the gradients flattened in fp32; a missing
    gradient counts as zeros."""
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    flat = torch.cat([p.grad.reshape(-1).float() for p in params])
    dist.all_reduce(flat, group=group)
    at = 0
    for p in params:
        n = p.numel()
        p.grad.copy_(flat[at:at + n].view(p.shape))
        at += n


def make_train_step(spec: StereoSpec, optimizer: Optional[OptimizerSpec]
                    = None, mesh=None, remat: bool = True,
                    compute_dtype: Optional[torch.dtype] = None,
                    device=None):
    """Build ``(init_fn, step_fn)`` for one stereo model.

    - ``init_fn(params) -> TrainState``: ``params`` is the JAX package's
      nested numpy param dict; the masters are fp32 on ``device``
      (``None``: the card, see `resolve_device`);
    - ``step_fn(state, left, right, target_disp, valid) -> (state,
      metrics)``: numpy or tensors; ``metrics`` holds the fp32 ``loss`` and
      ``epe`` as 0-d tensors on the device (no host sync per step).

    ``compute_dtype`` (``torch.bfloat16``): mixed precision, the convs'
    operands cast down and every conv summed in fp32 and rounded once
    (`ops/convolution.py`); loss and metrics are fp32.

    ``mesh``: a (data, spatial) `DeviceMesh` (`parallel/sharding.py`);
    every rank calls ``step_fn`` with the global batch and takes its shard
    (see the module docstring); ``device`` is this rank's, of the mesh's
    device type."""
    device = resolve_device(device)
    if mesh is not None and mesh.device_type != device.type:
        raise ValueError(f"device {device} for a mesh on {mesh.device_type}")
    optimizer = optimizer or OptimizerSpec("adam", 1e-4)  # optax.adam(1e-4)
    dtype = compute_dtype or torch.float32

    def init_fn(params) -> TrainState:
        net = params_from_numpy(spec, params, device=device, dtype=dtype,
                                trainable=True)
        opt, sched = optimizer.build(net.parameters())
        return TrainState(net, opt, 0, sched, optimizer)

    if mesh is not None:
        return init_fn, _mesh_step(spec, mesh, remat)

    def step_fn(state: TrainState, left, right, target, valid):
        target = _as_tensor(target, device, torch.float32)
        valid = _as_tensor(valid, device, torch.float32)
        loss, pred = stereo_loss(spec, state.params, left, right, target,
                                 valid, remat=remat)
        apply_update(state, loss)
        with torch.no_grad():
            epe = smooth_l1_disparity_loss(pred, target, valid, delta=1e-9)
        return state, {"loss": loss.detach(), "epe": epe}

    return init_fn, step_fn


def _mesh_step(spec: StereoSpec, mesh, remat: bool):
    """The step over a mesh (see the module docstring)."""
    img = batch_sharding(mesh)
    group = mesh.get_group(SPATIAL_AXIS) if mesh.size(1) > 1 else None

    def step_fn(state: TrainState, left, right, target, valid):
        net = state.params
        n, rows = left.shape[:2]
        check_batch(mesh, n)
        left, right, target, valid = (local_shard(mesh, a, img)
                                      for a in (left, right, target, valid))
        with span("train/forward"):
            target = _as_tensor(target, net.device, torch.float32)
            valid = _as_tensor(valid, net.device, torch.float32)
            pred = _prediction(spec, net, left, right, remat=remat,
                               shard=None if group is None
                               else (group, rows))
            count = valid.sum().reshape(1)
            dist.all_reduce(count)
            count = torch.clamp(count, min=1.0)
            loss = (_smooth_l1(pred, target, 1.0) * valid).sum() / count[0]
        backward(state, loss)
        all_reduce_grads(net.parameters())
        optimizer_step(state)
        with torch.no_grad():
            epe = (_smooth_l1(pred, target, 1e-9) * valid).sum() / count[0]
            metrics = torch.stack([loss.detach(), epe])
            dist.all_reduce(metrics)
        return state, {"loss": metrics[0], "epe": metrics[1]}

    return step_fn
