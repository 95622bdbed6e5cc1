"""Percent of its roofline: the 3D decoder's transposed convs, the op
`redtail_torch::deconv3d_s2` (one region a decoder layer of the fused
head), against their least bytes at 3.35 TB/s: each layer's bf16 input and
skip read once, its bf16 output written once, its bf16 weights and fp32
bias read once. The bound of a frame is the sum over the decoder's layers;
the regions in the traced window are that many calls a frame, so the bound
of the window is the frame's times calls / layers, over the device time of
the kernels launched inside the regions. The bytes are worked out here
from the configuration's layer shapes; a program without the op has no
such region, and the metric reads nothing."""

from typing import List, Tuple

from portbench.harness import counts

REGIONS = ("redtail_torch::deconv3d_s2",)


def layer_bytes(config: dict, hw, n: int = 1) -> List[Tuple[str, int]]:
    """(name, least bytes) of each 3D decoder layer of one forward of ``n``
    pairs at input ``hw``: the input (the layer before's output), the skip
    (none for the last layer), the output, the (3, 3, 3, c_in, c_out)
    weights in bf16 and the fp32 bias."""
    bf16, fp32 = counts.BF16_BYTES, counts.FP32_BYTES
    spatial = (config["max_disp"], *counts.half_hw(hw))
    sizes, chans = {}, None
    for name, c, s in config["enc3d"]:
        spatial = tuple(-(-v // s) for v in spatial)
        sizes[name], chans = (spatial, c), c
    out = []
    for name, c_out, skip in config.get("dec3d", ()):
        dst = sizes[skip][0] if skip else (2 * config["max_disp"], *hw)
        vol_in = n * spatial[0] * spatial[1] * spatial[2] * chans
        vol_out = n * dst[0] * dst[1] * dst[2] * c_out
        nbytes = (vol_in + vol_out * (2 if skip else 1)
                  + 27 * chans * c_out) * bf16 + c_out * fp32
        out.append((name, nbytes))
        spatial, chans = dst, c_out
    return out


def read(run):
    if run.trace is None or not run.work:
        return None
    calls, seconds = run.trace.regions.get(REGIONS[0], (0, 0.0))
    layers = layer_bytes(run.cell.config, run.hw, run.batch)
    if not calls or seconds <= 0 or not layers:
        return None
    frame_s = sum(b for _, b in layers) / counts.HBM_BYTES_PER_S
    return counts.roofline_share(frame_s / len(layers), calls, seconds)
