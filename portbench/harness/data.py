"""Inputs and weights made from the run's seed, on the device, in a few
large calls: one `torch.Generator` on the device draws the weights, then
the traffic's pool. The same seed gives the same numbers on the same kind
of device. Both the program and the reference take what is made here.

Weights: He-init (std sqrt(2 / fan in), fan in the kernel's size over
every axis but the last, as the program's own initializer counts it),
conditioned as a trained network is: biases drawn at 0.1, the residual
branches' second conv and the feature head scaled by 0.3, so the cost
volume stays O(1) and the soft-argmin is not saturated. The correlation
family's last transposed conv (its ``bneck_dec`` entry with no skip) is
scaled by 0.1, so the sigmoid it feeds is not saturated either: at plain
He-init 87-88% of a 321x1025 pair's pixels read under 0.01 or over 0.99
there (the reference on an H100), so their disparity says little of the
net; at 0.1, 1.4-3.2%.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench.reference.stereo import layer_table

BIAS_STD = 0.1
DAMPED = ("res_conv2", "encoder2D_out")
DAMPING = 0.3
SIGMOID_DAMPING = 0.1
SEED_MOD = 2 ** 63


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % SEED_MOD)
    return g


def make_weights(config: dict, g: torch.Generator, device) -> Dict:
    """The nested HWIO / DHWIO numpy param dict of the configuration's
    network: one draw on the device, scaled per leaf, one copy to the
    host."""
    leaves: List[Tuple[str, tuple, float]] = []
    last = {f"bneck_decoder2D/{name}"
            for name, _c, skip in config.get("bneck_dec", ()) if skip is None}
    for path, kshape, bshape in layer_table(config):
        std = math.sqrt(2.0 / math.prod(kshape[:-1]))
        if path.endswith(DAMPED):
            std *= DAMPING
        elif path in last:
            std *= SIGMOID_DAMPING
        leaves.append((f"{path}/weights", kshape, std))
        leaves.append((f"{path}/biases", bshape, BIAS_STD))
    sizes = torch.tensor([math.prod(s) for _p, s, _ in leaves])
    scale = torch.repeat_interleave(
        torch.tensor([std for _p, _s, std in leaves], dtype=torch.float32),
        sizes).to(device)
    flat = torch.randn(int(sizes.sum()), generator=g, device=device) * scale
    flat = flat.cpu().numpy()
    tree: Dict = {}
    at = 0
    for (key, shape, _std), size in zip(leaves, sizes.tolist()):
        *scopes, layer, var = key.split("/")
        node = tree
        for s in scopes + [layer]:
            node = node.setdefault(s, {})
        node[var] = flat[at:at + size].reshape(shape)
        at += size
    return tree


def _shifted(left: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """Each image (..., H, W, C) moved left by its shift (wrapping), so
    that a pixel at x in ``left`` lies at x - shift in the result."""
    w = left.shape[-2]
    cols = (torch.arange(w, device=left.device) + shifts[..., None]) % w
    index = cols[..., None, :, None].expand(left.shape)
    return torch.gather(left, -2, index)


def make_frames(config: dict, traffic: dict, g: torch.Generator, device
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The stream's pool: ``pool`` uint8 BGR (left, right) pairs at the
    model's size, random texture, each right frame the left one shifted by
    a disparity drawn in [0, 2 x max_disp) px. Host arrays (the node takes
    host frames) and the shifts."""
    h, w = config["input_hw"]
    p = traffic["pool"]
    left = torch.randint(0, 256, (p, h, w, 3), generator=g, device=device,
                         dtype=torch.uint8)
    shifts = torch.randint(0, 2 * config["max_disp"], (p,), generator=g,
                           device=device)
    right = _shifted(left, shifts)
    return left.cpu().numpy(), right.cpu().numpy(), shifts.cpu().numpy()


def make_batches(config: dict, traffic: dict, g: torch.Generator, device
                 ) -> List[Tuple[torch.Tensor, ...]]:
    """The training pool: ``pool`` batches of ``batch`` crops on the
    device: RGB in [0, 1] (the right crop the left one shifted), a dense
    target disparity in [0, 2 x max_disp) px, each crop's targets in a
    band of ``target_band`` px at a place of its own, and a valid mask
    with ``invalid_share`` of the pixels off."""
    p, n = traffic["pool"], traffic["batch"]
    h, w = traffic["crop"]
    top = 2 * config["max_disp"]
    band = traffic["target_band"]
    left = torch.rand((p, n, h, w, 3), generator=g, device=device)
    shifts = torch.randint(0, top, (p, n), generator=g, device=device)
    right = _shifted(left, shifts)
    base = torch.rand((p, n, 1, 1), generator=g, device=device) * (top - band)
    target = base + torch.rand((p, n, h, w), generator=g, device=device) \
        * band
    valid = (torch.rand((p, n, h, w), generator=g, device=device)
             >= traffic["invalid_share"]).float()
    return [(left[i], right[i], target[i], valid[i]) for i in range(p)]
