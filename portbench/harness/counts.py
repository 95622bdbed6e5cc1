"""The benchmark's own counts of operations and bytes, worked out from a
configuration's layer shapes: the yardstick of `mfu.*` and of each
kernel's `*_roofline`. The count is fixed by the network and the call
shapes, whatever form the program runs.

- A conv's nominal dense operations: 2 x N x output positions x kernel
  taps x input channels x output channels (TF-SAME output ceil(in / s)).
- A transposed conv's: 2 x N x input positions x kernel taps x its input
  channels x its output channels (every input meets the whole kernel).
- conv3D_1 counts as the dense conv3d over the (N, 2C, D, H', W') concat
  volume, as the published network states it.
- The correlation family: the correlation counts 2 x N x H' x W' x D x C
  (a product and a sum a channel, a disparity and a pixel; the soft-argmax
  after it is not counted); the bottleneck's convs (``bneck_encoder2D/*``)
  are 2D convs on the left image only (N), each at its strided
  half-resolution output size; its transposed convs (``bneck_decoder2D/*``)
  count as above.
- A kernel's bytes: each input read once and the output written once.

Peaks: NVIDIA H100 SXM data sheet, dense: 989 TFLOP/s bf16, 3.35 TB/s HBM.
"""

from __future__ import annotations

import math
from typing import List, Tuple

from portbench.reference.stereo import layer_table

BF16_PEAK_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
BF16_BYTES = 2
FP32_BYTES = 4


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def half_hw(hw) -> Tuple[int, int]:
    return _ceil(hw[0], 2), _ceil(hw[1], 2)


def layer_flops(config: dict, hw, n: int = 1) -> List[Tuple[str, int]]:
    """(path, nominal dense operations) of every layer of one forward of
    ``n`` pairs at input ``hw``."""
    h, w = hw
    h2, w2 = half_hw(hw)
    d = config["max_disp"]
    sizes, spatial = {}, (d, h2, w2)
    for name, _c, s in config["enc3d"]:
        spatial = tuple(_ceil(v, s) for v in spatial)
        sizes[f"encoder3D/{name}"] = spatial
    skips = {f"decoder3D/{name}": skip for name, _c, skip in config["dec3d"]}
    flat, bsizes = (h2, w2), {}
    for name, _c, s in config.get("bneck_channels", ()):
        flat = tuple(_ceil(v, s) for v in flat)
        bsizes[f"bneck_encoder2D/{name}"] = flat
    bskips = {f"bneck_decoder2D/{name}": skip
              for name, _c, skip in config.get("bneck_dec", ())}
    out = []
    if config.get("corr"):
        out.append(("corr_cost_volume+softargmax",
                    2 * n * h2 * w2 * d * _feature_channels(config)))
    for path, k, _b in layer_table(config):
        taps = math.prod(k[:-2])
        if path.startswith("encoder2D/"):
            # both towers, 2n images, each layer writing H' x W'
            out.append((path, 2 * 2 * n * h2 * w2 * taps * k[-2] * k[-1]))
        elif path.startswith("bneck_encoder2D/"):
            out.append((path, 2 * n * math.prod(bsizes[path]) * taps
                        * k[-2] * k[-1]))
        elif path.startswith("bneck_decoder2D/"):
            # a transposed conv: every input position meets the whole kernel
            out.append((path, 2 * n * math.prod(flat) * taps
                        * k[-1] * k[-2]))
            skip = bskips[path]
            flat = (h, w) if skip is None \
                else bsizes[f"bneck_encoder2D/{skip}"]
        elif path.startswith("encoder3D/"):
            spatial = sizes[path]
            out.append((path, 2 * n * math.prod(spatial) * taps
                        * k[-2] * k[-1]))
        else:
            # a transposed conv: every input position meets the whole kernel
            out.append((path, 2 * n * math.prod(spatial) * taps
                        * k[-1] * k[-2]))
            skip = skips[path]
            spatial = (2 * d, h, w) if skip is None \
                else sizes[f"encoder3D/{skip}"]
    return out


def forward_flops(config: dict, hw, n: int = 1) -> int:
    return sum(f for _p, f in layer_flops(config, hw, n))


def emission_bytes(config: dict, hw, n: int = 1, elem: int = BF16_BYTES
                   ) -> int:
    """`redtail_torch::fused_cv_emit`, full layout: the left maps (N, H',
    W', 3K) and right maps (N, H', W', 6K) read, the fp32 bias (K) read,
    the (N, D, H', W', K) output written."""
    h2, w2 = half_hw(hw)
    k = config["enc3d"][0][1]
    d = config["max_disp"]
    maps = n * h2 * w2 * 9 * k * elem
    return maps + k * FP32_BYTES + n * d * h2 * w2 * k * elem


def _feature_channels(config: dict) -> int:
    ch = config["enc2d_channels"]
    return ch[-1] if config["encoder2d"] == "plain" else ch[0]


def corr_softargmax_bytes(config: dict, hw, n: int = 1,
                          elem: int = BF16_BYTES) -> int:
    """`redtail_torch::corr_cost_volume`'s soft-argmax epilogue: two (N,
    H', W', C) maps read, the (N, H', W') fp32 map written."""
    h2, w2 = half_hw(hw)
    c = _feature_channels(config)
    return 2 * n * h2 * w2 * c * elem + n * h2 * w2 * FP32_BYTES


def concat_bytes(config: dict, hw, n: int, elem: int = BF16_BYTES) -> int:
    """`redtail_torch::cost_volume_concat`: two (N, H', W', C) maps read,
    the (N, D, H', W', 2C) volume written."""
    h2, w2 = half_hw(hw)
    c = _feature_channels(config)
    d = config["max_disp"]
    return 2 * n * h2 * w2 * c * elem + n * d * h2 * w2 * 2 * c * elem


def concat_bwd_bytes(config: dict, hw, n: int, elem: int = BF16_BYTES
                     ) -> int:
    """The volume's backward: the (N, D, H', W', 2C) cotangent read, the
    two (N, H', W', C) gradients written."""
    return concat_bytes(config, hw, n, elem)


def roofline_share(bound_s_per_call: float, calls: int,
                   seconds: float) -> float:
    """Percent: the least time the calls could take over their time."""
    return 100.0 * bound_s_per_call * calls / seconds
