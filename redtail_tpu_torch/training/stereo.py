"""End-to-end stereo training (`redtail_tpu/training/stereo.py`): dataset ->
steps -> checkpoints -> D1 / EPE.

The same `StereoNet` that serves is trained here, on the card by default
(``device``), with resumable checkpoints and periodic KITTI-metric
evaluation (`utils/metrics.py`). With ``data_parallel > 1`` the call runs
in each of that many ranks (`parallel/launch.py`; `apps/train_app.py
--data-parallel` starts them): every rank draws the same global batch from
the seeded loader and takes its slice (`make_train_step(mesh=)`), so the
run equals one process over the global batch; rank 0 alone writes the
checkpoints, the log and the final D1 / EPE. CLI in `apps/train_app.py`;
dataset side in `data/kitti.py`.
"""

from __future__ import annotations

import dataclasses
import json
import math
import time
from pathlib import Path
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from redtail_tpu_torch import resolve_device
from redtail_tpu_torch.models.stereo import (STEREO_SPECS, StereoNet,
                                             init_stereo_params,
                                             params_from_numpy,
                                             params_to_numpy)
from redtail_tpu_torch.parallel.training import (STATE_KEYS, OptimizerSpec,
                                                 TrainState, make_train_step)
from redtail_tpu_torch.utils.checkpoint import (_decode_npz, _encode_npz,
                                                _flatten, _unflatten)
from redtail_tpu_torch.utils.metrics import disparity_errors

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class StereoTrainConfig:
    """Typed config (the JAX package's fields and defaults)."""

    model: str = "nvtiny"
    crop_hw: Tuple[int, int] = (160, 512)   # training crop (model input)
    max_disp: Optional[int] = None          # override spec (cv resolution)
    batch_size: int = 4
    steps: int = 1000
    lr: float = 1e-4
    warmup_steps: int = 100
    weight_decay: float = 0.0
    seed: int = 0
    eval_every: int = 0                     # 0 = only at the end
    ckpt_every: int = 0                     # 0 = only at the end
    ckpt_dir: Optional[str] = None
    resume: bool = False
    data_parallel: int = 1                  # ranks on the data axis
    # Compute dtype of the convs: master weights and optimizer moments are
    # always fp32; 'bfloat16' runs mixed precision (operands cast down, fp32
    # sums rounded once, `ops/convolution.py`).
    dtype: str = "float32"


def _make_spec(cfg: StereoTrainConfig):
    spec = STEREO_SPECS[cfg.model]
    kwargs = {"input_hw": tuple(cfg.crop_hw)}
    if cfg.max_disp is not None:
        kwargs["max_disp"] = cfg.max_disp
    return dataclasses.replace(spec, **kwargs)


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0
                                 ) -> Callable[[int], float]:
    """`optax.warmup_cosine_decay_schedule`: linear from ``init_value`` to
    ``peak_value`` over ``warmup_steps``, then a cosine to ``end_value`` at
    ``decay_steps`` (warmup included), flat after."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = min(max(count, 0), warmup_steps) / warmup_steps
            return init_value + (peak_value - init_value) * frac
        t = min(count - warmup_steps, decay_steps - warmup_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * t
                                     / (decay_steps - warmup_steps)))
        return peak_value * ((1 - alpha) * cosine + alpha)

    return schedule


def _make_optimizer(cfg: StereoTrainConfig) -> OptimizerSpec:
    sched = warmup_cosine_decay_schedule(
        0.0, cfg.lr, max(1, cfg.warmup_steps),
        max(cfg.steps, cfg.warmup_steps + 1))
    if cfg.weight_decay > 0:
        return OptimizerSpec("adamw", sched, weight_decay=cfg.weight_decay)
    return OptimizerSpec("adam", sched)


# ------------------------------------------------------------- checkpoints


def _opt_leaves(opt: torch.optim.Optimizer, name: str):
    """The optimizer's state as positional numpy leaves: per parameter, in
    order, its `STATE_KEYS` entries (zeros before the first update)."""
    leaves = []
    for p in (p for g in opt.param_groups for p in g["params"]):
        st = opt.state.get(p, {})
        for key in STATE_KEYS[name]:
            v = st.get(key)
            if v is None:
                v = torch.zeros(() if key == "step" else p.shape)
            leaves.append(v.detach().float().cpu().numpy())
    return leaves


def save_train_state(state: TrainState, path) -> Path:
    """Full resumable state (fp32 params, optimizer state, step) as one
    portable .npz. Optimizer leaves are positional, so loading needs the
    same optimizer configuration."""
    flat = {f"params/{k}": v for k, v in
            _flatten(params_to_numpy(state.params)).items()}
    for i, leaf in enumerate(_opt_leaves(state.opt_state,
                                         state.optimizer.name)):
        flat[f"opt/{i:04d}"] = leaf
    flat["opt_name"] = np.asarray(state.optimizer.name)
    flat["step"] = np.asarray(state.step, np.int32)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **_encode_npz(flat))
    return path


def train_state_path(cfg: StereoTrainConfig) -> Path:
    """The train-state npz that `train_stereo` writes in ``cfg.ckpt_dir``
    and resumes from."""
    return Path(cfg.ckpt_dir) / f"{cfg.model}_train.npz"


def load_train_state(path, template: TrainState) -> TrainState:
    """Restore a state saved by `save_train_state` into ``template`` (a
    freshly initialized state for the same spec and optimizer): its
    parameters take the saved values in place, its optimizer the saved
    moments, its schedule the saved step. Raises ValueError on a
    checkpoint of another optimizer."""
    with np.load(Path(path)) as data:
        flat = _decode_npz({k: data[k] for k in data.files})
    name = template.optimizer.name
    saved = str(flat.get("opt_name", "?"))
    opt_leaves = [flat[k] for k in sorted(flat) if k.startswith("opt/")]
    params = [p for g in template.opt_state.param_groups for p in g["params"]]
    keys = STATE_KEYS[name]
    if saved != name or len(opt_leaves) != len(params) * len(keys):
        raise ValueError(
            f"{path}: checkpoint has {len(opt_leaves)} optimizer leaves of "
            f"{saved!r}, the optimizer {name!r} expects "
            f"{len(params) * len(keys)}: optimizer config changed?")
    tree = _unflatten({k[len("params/"):]: v for k, v in flat.items()
                       if k.startswith("params/")})
    net = template.params
    loaded = params_from_numpy(net.spec, tree, device="cpu", trainable=True)
    with torch.no_grad():
        for mine, theirs in zip(net.parameters(), loaded.parameters()):
            mine.copy_(theirs)
    opt = template.opt_state
    sd = opt.state_dict()
    sd["state"] = {}
    for i, p in enumerate(params):
        entry = {}
        for j, key in enumerate(keys):
            leaf = opt_leaves[i * len(keys) + j]
            if leaf.shape != (() if key == "step" else tuple(p.shape)):
                raise ValueError(f"{path}: optimizer leaf {key} of "
                                 f"parameter {i} has shape {leaf.shape}, not "
                                 f"{tuple(p.shape)}: optimizer config "
                                 "changed?")
            entry[key] = torch.from_numpy(np.array(leaf, np.float32))
        sd["state"][i] = entry
    opt.load_state_dict(sd)
    step = int(flat["step"])
    sched = None if template.schedule is None else \
        torch.optim.lr_scheduler.LambdaLR(opt, template.optimizer.lr,
                                          last_epoch=step - 1)
    return TrainState(net, opt, step, sched, template.optimizer)


# ------------------------------------------------------------------ eval


def _serving_net(spec, params, device, dtype) -> StereoNet:
    tree = params_to_numpy(params) if isinstance(params, StereoNet) \
        else params
    return params_from_numpy(spec, tree, device=device, dtype=dtype)


def evaluate_stereo(spec, params, dataset, *, max_images: int = 0,
                    batch_hw: Optional[Tuple[int, int]] = None,
                    device=None, dtype: torch.dtype = torch.float32) -> dict:
    """D1 / EPE over a dataset's center crops at the spec's input size.

    Evaluation runs the serving forward on a net built from ``params`` (a
    `StereoNet` or a numpy tree) in ``dtype``, the frames cast to it: fp32
    by default (the masters' dtype, as the JAX package evaluates in its
    params' dtype; bf16 is its evaluation of a bf16 tree); crops keep one
    shape. The correlation model's output is scaled to pixels by the
    width, as in training."""
    hw = batch_hw or spec.input_hw
    eval_spec = dataclasses.replace(spec, input_hw=tuple(hw))
    dev = resolve_device(device if device is not None else (
        params.device if isinstance(params, StereoNet) else None))
    net = _serving_net(eval_spec, params, dev, dtype)
    scale = eval_spec.input_hw[1] if eval_spec.corr else 1.0
    n = len(dataset) if max_images == 0 else min(max_images, len(dataset))
    rng = np.random.RandomState(0)
    d1s, epes, n_px = [], [], 0
    for i in range(n):
        left, right, disp, valid = dataset.sample(i)
        left, right, disp, valid = dataset._crop(
            [left, right, disp, valid], hw, rng, random=False)
        if not (valid > 0).any():
            continue  # no GT in this crop (sparse KITTI / GT-less pair)
        with torch.inference_mode():
            pred = net(torch.from_numpy(left[None]).to(dev, dtype),
                       torch.from_numpy(right[None]).to(dev, dtype)) * scale
        pred = pred.float().cpu().numpy()[0]
        err = disparity_errors(pred, disp, valid=valid > 0)
        d1s.append(err["d1"] * err["n_valid"])
        epes.append(err["epe"] * err["n_valid"])
        n_px += err["n_valid"]
    n_px = max(n_px, 1)
    return {"d1": float(sum(d1s) / n_px), "epe": float(sum(epes) / n_px),
            "images": n}


# ------------------------------------------------------------------ train


def train_stereo(cfg: StereoTrainConfig, dataset, eval_dataset=None,
                 log_fn: Callable[[dict], None] = None,
                 device=None) -> TrainState:
    """Run the training loop; returns the final `TrainState`.

    ``dataset`` / ``eval_dataset``: `data/kitti.py` KittiStereoDataset (or
    any object with the same `batches` / `sample` / `_crop` surface).
    ``device``: ``None`` is the card (see `resolve_device`); with
    ``cfg.data_parallel > 1``, this rank's. The random init is the port's
    numpy one (`init_stereo_params`), not `jax.random`'s."""
    if cfg.dtype not in DTYPES:
        raise ValueError(
            f"training dtype must be float32 or bfloat16, got {cfg.dtype}")
    compute_dtype = DTYPES[cfg.dtype]
    spec = _make_spec(cfg)
    mesh, main = None, True
    if cfg.data_parallel > 1:
        import torch.distributed as dist
        from redtail_tpu_torch.parallel.sharding import make_mesh
        ranks = dist.get_world_size() if dist.is_initialized() else 1
        if ranks < cfg.data_parallel:
            raise RuntimeError(
                f"data_parallel={cfg.data_parallel} but only {ranks} ranks "
                "running (start them with parallel.launch.spawn_ranks, or "
                "train_app stereo --data-parallel)")
        mesh = make_mesh(data=cfg.data_parallel, spatial=1,
                         device_type=resolve_device(device).type)
        if cfg.batch_size % cfg.data_parallel:
            raise ValueError("data_parallel must divide batch_size")
        main = dist.get_rank() == 0
    init_fn, step_fn = make_train_step(
        spec, _make_optimizer(cfg), mesh=mesh, compute_dtype=compute_dtype,
        device=device)
    state = init_fn(init_stereo_params(spec, seed=cfg.seed))

    ckpt_path = train_state_path(cfg) if cfg.ckpt_dir else None
    if cfg.resume and ckpt_path and ckpt_path.exists():
        state = load_train_state(ckpt_path, state)

    log = log_fn or (lambda rec: print(json.dumps(rec), flush=True))
    if not main:
        log, ckpt_path, eval_dataset = (lambda rec: None), None, None
    rng = np.random.RandomState(cfg.seed + 1)
    step_i = state.step
    last_ckpt = last_eval = -1
    t0 = time.perf_counter()
    while step_i < cfg.steps:
        for left, right, disp, valid in dataset.batches(
                cfg.batch_size, cfg.crop_hw, rng=rng):
            if step_i >= cfg.steps:
                break
            state, metrics = step_fn(state, left, right, disp, valid)
            step_i += 1
            if step_i % 10 == 0 or step_i == cfg.steps:
                log({"step": step_i,
                     "loss": round(float(metrics["loss"]), 5),
                     "epe": round(float(metrics["epe"]), 4),
                     "sec": round(time.perf_counter() - t0, 2)})
            if ckpt_path and cfg.ckpt_every and step_i % cfg.ckpt_every == 0:
                save_train_state(state, ckpt_path)
                last_ckpt = step_i
            if (eval_dataset is not None and cfg.eval_every
                    and step_i % cfg.eval_every == 0):
                ev = evaluate_stereo(spec, state.params, eval_dataset)
                log({"step": step_i, "eval_d1": round(ev["d1"], 4),
                     "eval_epe": round(ev["epe"], 4)})
                last_eval = step_i

    if ckpt_path and last_ckpt != step_i:
        save_train_state(state, ckpt_path)
        log({"step": step_i, "checkpoint": str(ckpt_path)})
    if eval_dataset is not None and last_eval != step_i:
        ev = evaluate_stereo(spec, state.params, eval_dataset)
        log({"step": step_i, "eval_d1": round(ev["d1"], 4),
             "eval_epe": round(ev["epe"], 4)})
    return state
