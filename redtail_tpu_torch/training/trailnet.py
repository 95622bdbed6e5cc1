"""TrailNet training (`redtail_tpu/training/trailnet.py`): augmentation and
the entropy-regularized loss.

- `trail_loss`: the reference's `CrossEntropySoftmaxWithEntropyLossLayer`
  (`models/nets/python-layers.py:243-313`): label-smoothed cross entropy
  minus an entropy reward (0.01) plus a side-swap penalty (0.0001) on the
  probability of the opposite side class, on true logits.
- Augmentation (`TrailAugLayer`, `python-layers.py:70-240`): top cut,
  random scale + crop as a gather, bilinear rotation with edge clamp,
  horizontal flip with the 3- and 5-class label remaps (on every head),
  brightness / contrast. The random draws (`augment_draws`, from a
  `torch.Generator`) are apart from the deterministic warp
  (`augment_warp`), which follows the JAX function's float32 arithmetic
  step for step, so the tests feed it the draws `jax.random` makes and
  compare; the port's own draws are its generator's, not JAX's.
- `make_trailnet_train_step`: SGD with momentum 0.9 over the native
  `TrailNet` (``return_logits=True``), both heads on their own loss. No
  CUDA kernel of the port lies on this path: its convs are cuDNN's
  round-once convs (`ops/convolution.py`), on the card unless asked for
  the CPU.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from redtail_tpu_torch import resolve_device
from redtail_tpu_torch.models.trailnet import TrailNet, params_from_numpy
from redtail_tpu_torch.parallel.training import OptimizerSpec, apply_update


# ------------------------------------------------------------------ loss


def trail_loss(logits: torch.Tensor, labels: torch.Tensor, *,
               ent_scale: float = 0.01, p_scale: float = 0.0001,
               label_eps: float = 0.0) -> torch.Tensor:
    """Per-head loss: smoothed CE - ent_scale * entropy + swap penalty.

    logits (N, 3), labels (N,) int in {0: left, 1: center, 2: right}."""
    logits = logits.float()
    labels = labels.long()
    n_cls = logits.shape[-1]
    log_sm = F.log_softmax(logits, dim=-1)
    sm = log_sm.exp()
    onehot = F.one_hot(labels, n_cls).float()
    smooth_lab = onehot * (1.0 - label_eps - label_eps / (n_cls - 1)) \
        + label_eps / (n_cls - 1)
    ce = -(smooth_lab * log_sm).sum(-1)
    ent = -(sm * log_sm).sum(-1)
    # mass on the mirror class (2 - lab); none for center (lab = 1)
    side_scale = torch.where(labels == 1, 0.0, p_scale)
    opposite = sm.gather(1, (2 - labels)[:, None])[:, 0]
    return (ce - ent_scale * ent + side_scale * opposite).mean()


# -------------------------------------------------------------- augment

HFLIP3_REMAP = (2, 1, 0)
HFLIP5_REMAP = (4, 3, 2, 1, 0)


def augment_draws(gen: torch.Generator, n: int, h: int, w: int, *,
                  scale_max: float = 1.2, rotate_deg: float = 15.0,
                  color_jitter: float = 0.25) -> Dict[str, torch.Tensor]:
    """The random part of ``n`` samples' augmentation, as the JAX function
    draws it: ``scale`` in [1, scale_max), ``oy`` in [0, h), ``ox`` in
    [0, w), ``angle`` in degrees in [-rotate_deg, rotate_deg), ``flip``,
    ``bc`` (brightness, contrast) in [1 - jitter, 1 + jitter)."""
    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand((n, *shape), generator=gen)

    return {"scale": uniform(1.0, scale_max),
            "oy": torch.randint(0, h, (n,), generator=gen),
            "ox": torch.randint(0, w, (n,), generator=gen),
            "angle": uniform(-rotate_deg, rotate_deg),
            "flip": torch.rand(n, generator=gen) < 0.5,
            "bc": uniform(1 - color_jitter, 1 + color_jitter, 2)}


def _rotate_bilinear(img: torch.Tensor, angle_rad: torch.Tensor):
    """Rotate each (H, W, C) image of the batch about its center by its
    angle, bilinear, edge-clamped (`redtail_tpu/training/trailnet.py:
    _rotate_bilinear`)."""
    n, h, w, _ = img.shape
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy = torch.arange(h, device=img.device)[None, :, None].float()
    xx = torch.arange(w, device=img.device)[None, None, :].float()
    cos = torch.cos(angle_rad)[:, None, None]
    sin = torch.sin(angle_rad)[:, None, None]
    sy = cy + (yy - cy) * cos - (xx - cx) * sin
    sx = cx + (yy - cy) * sin + (xx - cx) * cos
    sy = sy.clamp(0, h - 1)
    sx = sx.clamp(0, w - 1)
    y0 = torch.floor(sy).long()
    x0 = torch.floor(sx).long()
    y1 = (y0 + 1).clamp(max=h - 1)
    x1 = (x0 + 1).clamp(max=w - 1)
    wy = (sy - y0)[..., None]
    wx = (sx - x0)[..., None]
    b = torch.arange(n, device=img.device)[:, None, None]
    top = img[b, y0, x0] * (1 - wx) + img[b, y0, x1] * wx
    bot = img[b, y1, x0] * (1 - wx) + img[b, y1, x1] * wx
    return top * (1 - wy) + bot * wy


def augment_warp(images: torch.Tensor, labels: torch.Tensor,
                 draws: Dict[str, torch.Tensor], *, top_cut: float = 0.0,
                 hflip_mode: str = "hflip3"):
    """The deterministic part: (N, H, W, 3) float [0, 1] images and (N,) or
    (N, heads) int labels -> the same shapes, given ``draws``."""
    n, h, w, _ = images.shape
    dev = images.device
    d = {k: v.to(dev) for k, v in draws.items()}
    img = images.float()
    if top_cut > 0:
        cut = int(h * top_cut)
        img = torch.cat([img[:, cut:], img[:, -1:].expand(n, cut, w, 3)], 1)

    # random scale + crop, as a gather of a warped grid
    scale = d["scale"].float()
    ch = (h / scale).int().clamp(min=1)
    cw = (w / scale).int().clamp(min=1)
    oy = d["oy"].int() % (h - ch).clamp(min=1)
    ox = d["ox"].int() % (w - cw).clamp(min=1)
    ar_h = torch.arange(h, device=dev, dtype=torch.int32)
    ar_w = torch.arange(w, device=dev, dtype=torch.int32)
    yy = oy[:, None] + ((ar_h[None] * (ch - 1)[:, None]).float()
                        / (h - 1)).int()
    xx = ox[:, None] + ((ar_w[None] * (cw - 1)[:, None]).float()
                        / (w - 1)).int()
    b = torch.arange(n, device=dev)[:, None, None]
    img = img[b, yy.clamp(0, h - 1).long()[:, :, None],
              xx.clamp(0, w - 1).long()[:, None, :]]

    img = _rotate_bilinear(img, d["angle"].float() * math.pi / 180.0)

    # horizontal flip with the label remap, every head with the same coin
    remap = {"hflip3": HFLIP3_REMAP, "hflip5": HFLIP5_REMAP}.get(hflip_mode)
    flip = d["flip"].bool()
    if remap is not None:
        table = torch.tensor(remap, device=labels.device)
        fl = flip.to(labels.device).reshape(-1, *[1] * (labels.dim() - 1))
        labels = torch.where(fl, table[labels.long()].to(labels.dtype),
                             labels)
    img = torch.where(flip[:, None, None, None], img.flip(2), img)

    # brightness / contrast (the PIL enhancer stack, linearized)
    bc = d["bc"].float()
    bright, contrast = bc[:, 0, None, None, None], bc[:, 1, None, None, None]
    mean = img.mean(dim=(1, 2), keepdim=True)
    img = ((img - mean) * contrast + mean * bright).clamp(0.0, 1.0)
    return img, labels


def augment_batch(gen: torch.Generator, images: torch.Tensor,
                  labels: torch.Tensor, *, top_cut: float = 0.0,
                  scale_max: float = 1.2, rotate_deg: float = 15.0,
                  hflip_mode: str = "hflip3", color_jitter: float = 0.25):
    """One augmentation of each sample: draws from ``gen``, then the
    warp."""
    n, h, w, _ = images.shape
    draws = augment_draws(gen, n, h, w, scale_max=scale_max,
                          rotate_deg=rotate_deg, color_jitter=color_jitter)
    return augment_warp(images, labels, draws, top_cut=top_cut,
                        hflip_mode=hflip_mode)


def augment_sample(gen: torch.Generator, img: torch.Tensor,
                   label: torch.Tensor, **kwargs):
    """One (H, W, 3) float [0, 1] sample and its label(s)."""
    out, lab = augment_batch(gen, img[None], torch.as_tensor(label)[None],
                             **kwargs)
    return out[0], lab[0]


# ------------------------------------------------------------ train step


@dataclasses.dataclass
class TrailTrainState:
    """``params``: the native `TrailNet` (fp32); the rest as the stereo
    `TrainState`."""

    params: TrailNet
    opt_state: torch.optim.Optimizer
    step: int
    schedule: Optional[torch.optim.lr_scheduler.LambdaLR]
    optimizer: OptimizerSpec


def trailnet_loss(net: TrailNet, images, rot_labels, off_labels, *,
                  ent_scale: float = 0.01, p_scale: float = 0.0001,
                  label_eps: float = 0.0):
    """(l1 + l2, (l1, l2)): `trail_loss` of each head's logits."""
    lg_rot, lg_off = net(images, return_logits=True)
    kw = dict(ent_scale=ent_scale, p_scale=p_scale, label_eps=label_eps)
    l1 = trail_loss(lg_rot, rot_labels, **kw)
    l2 = trail_loss(lg_off, off_labels, **kw)
    return l1 + l2, (l1, l2)


def make_trailnet_train_step(optimizer: Optional[OptimizerSpec] = None, *,
                             ent_scale: float = 0.01,
                             p_scale: float = 0.0001,
                             label_eps: float = 0.0, augment: bool = True,
                             device=None):
    """``(init_fn, step_fn)`` over the native SResNet-18 in fp32.

    ``init_fn(params)``: the JAX package's native numpy tree.
    ``step_fn(state, gen, images, rot_labels, off_labels) -> (state,
    metrics)``: images (N, 180, 320, 3) raw 0-255, labels (N,); ``gen``
    (a CPU `torch.Generator`) makes the augmentation's draws. ``device``:
    ``None`` is the card."""
    device = resolve_device(device)
    optimizer = optimizer or OptimizerSpec("sgd", 1e-3, momentum=0.9)
    kw = dict(ent_scale=ent_scale, p_scale=p_scale, label_eps=label_eps)

    def init_fn(params) -> TrailTrainState:
        net = params_from_numpy(params, device=device, dtype=torch.float32)
        opt, sched = optimizer.build(net.parameters())
        return TrailTrainState(net, opt, 0, sched, optimizer)

    def step_fn(state: TrailTrainState, gen, images, rot_labels,
                off_labels):
        images = torch.as_tensor(np.asarray(images, np.float32)).to(device)
        rot = torch.as_tensor(np.asarray(rot_labels)).to(device).long()
        off = torch.as_tensor(np.asarray(off_labels)).to(device).long()
        if augment:
            both = torch.stack([rot, off], dim=-1)
            img01, both = augment_batch(gen, images / 255.0, both)
            rot, off = both[:, 0], both[:, 1]
            images = img01 * 255.0
        loss, (l1, l2) = trailnet_loss(state.params, images, rot, off, **kw)
        apply_update(state, loss)
        return state, {"loss": loss.detach(), "rot_loss": l1.detach(),
                       "off_loss": l2.detach()}

    return init_fn, step_fn
