"""INT8-activation serving for the stereo models
(`redtail_tpu/quant/stereo_int8.py`).

The reference's INT8 ladder (`tensor_net.cpp:92-119` mode selection and
`Int8EntropyCalibrator`) applied to the stereo nets: the 2D conv stacks
under `int8_prefixes` (the siamese encoder of every model) run as int8 x
int8 with an exact integer sum, per-channel weight scales and per-layer
calibrated activation scales (`quant/ptq.py:conv2d_int8`); the cost
volumes, soft-argmax, 3D and transposed convs stay in the float path.

Usage:
    scales = calibrate_stereo(spec, params, frames, device="cpu")
    qparams = quantize_stereo_params_int8(params, scales)
    net = params_from_numpy(spec, qparams, device="cpu")

Calibration runs the model itself: a forward pre-hook on each eligible
conv module records its input, as the JAX package's `_c2d` tap does. The
two towers run as one batch of two and share their modules, so a hook sees
both and both count, the left first, as in JAX. Each input is subsampled
exactly as JAX does: |x| flattened in NHWC order (the port's activations
are NCHW in channels-last memory, whose plain flattening would take other
samples), then ``flat[::max(1, n // 65536)][:65536]``.

The correlation model quantizes only its siamese encoder: the bottleneck's
input concat(conv1 features, disparity in [0, 1]) cannot share one
per-tensor scale (the JAX package measured 73.8% D1 with it in int8,
0.90% without).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from redtail_tpu_torch.quant.ptq import (CalibrationCollector,
                                         quantize_per_channel)

# Leaves under these roots run int8; transposed-conv decoders and the 3D
# stack stay in the float path.
INT8_PREFIXES = ("encoder2D", "bneck_encoder2D")


def int8_prefixes(spec) -> Tuple[str, ...]:
    """Which conv stacks run int8 for this model: only the siamese encoder
    for the correlation model, both roots for the concat-volume models."""
    return ("encoder2D",) if getattr(spec, "corr", False) else INT8_PREFIXES


def _walk_conv_leaves(params, prefix=""):
    for k, v in params.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            if "weights" in v and np.asarray(v["weights"]).ndim == 4:
                yield path, v
            else:
                yield from _walk_conv_leaves(v, path)


def _nhwc_sample(x: torch.Tensor) -> np.ndarray:
    """JAX's on-device subsample of one conv input (N, C, H, W): |x| in
    NHWC order, every ``n // 65536``-th element, at most 65536."""
    flat = x.abs().permute(0, 2, 3, 1).reshape(-1)
    stride = max(1, flat.numel() // 65536)
    return flat[::stride][:65536].float().cpu().numpy()


@torch.no_grad()
def calibrate_stereo(spec, params,
                     frames: Sequence[Tuple[np.ndarray, np.ndarray]], *,
                     method: str = "percentile", percentile: float = 99.99,
                     device=None,
                     dtype: torch.dtype = torch.float32) -> Dict[str, float]:
    """Per-conv-layer input-activation scales (leaf path -> scale).

    ``frames``: (left, right) pairs, (H, W, 3) or (N, H, W, 3) float RGB in
    [0, 1], the model's input contract. ``params``: the nested numpy param
    tree, run as a `StereoNet` built here on ``device`` (``None`` is the
    card) in ``dtype`` (the JAX package calibrates in its params' dtype),
    or a `StereoNet` itself. Default method ``percentile`` (the choice for
    random weights; ``"entropy"`` for trained ones)."""
    from redtail_tpu_torch.models.stereo import (StereoNet,
                                                 _spec_layer_shapes,
                                                 params_from_numpy)

    net = params if isinstance(params, StereoNet) else params_from_numpy(
        spec, params, device=device, dtype=dtype)
    paths = [path for path, kshape, _ in _spec_layer_shapes(spec)
             if len(kshape) == 4 and path.startswith(int8_prefixes(spec))]
    collector = CalibrationCollector(method=method, percentile=percentile)
    recorded: Dict[str, List[np.ndarray]] = {}

    def hook(path):
        towers = path.startswith("encoder2D")

        def record(_module, args):
            x = args[0]
            halves = x.chunk(2) if towers else (x,)
            recorded.setdefault(path, []).extend(_nhwc_sample(h)
                                                 for h in halves)
        return record

    handles = [net.get_submodule(p.replace("/", "."))
               .register_forward_pre_hook(hook(p)) for p in paths]
    try:
        for left, right in frames:
            left, right = (torch.as_tensor(np.asarray(a, np.float32))
                           .to(device=net.device, dtype=net.dtype)
                           for a in (left, right))
            if left.dim() == 3:
                left, right = left[None], right[None]
            recorded.clear()
            net(left, right)
            for path, acts in recorded.items():
                for act in acts:
                    collector.observe(path, act)
    finally:
        for h in handles:
            h.remove()
    return collector.scales()


def quantize_stereo_params_int8(params, act_scales: Dict[str, float]):
    """Replace calibrated 2D conv leaves with int8 leaves ({weights_q,
    w_scale, x_scale, biases}); everything else unchanged."""
    def q(node, prefix=""):
        out = {}
        for k, v in node.items():
            path = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict) and "weights" in v and path in act_scales:
                wq, sc = quantize_per_channel(np.asarray(v["weights"],
                                                         np.float32), axis=-1)
                out[k] = {"weights_q": wq,
                          "w_scale": sc.reshape(-1),
                          "x_scale": np.float32(act_scales[path]),
                          "biases": v["biases"]}
            elif isinstance(v, dict):
                out[k] = q(v, path)
            else:
                out[k] = v
        return out
    return q(params)


def int8_layer_paths(params, spec=None) -> List[str]:
    """Conv-leaf paths that run int8 (pass ``spec`` to apply the per-model
    prefix policy, see `int8_prefixes`)."""
    prefixes = INT8_PREFIXES if spec is None else int8_prefixes(spec)
    return [p for p, _ in _walk_conv_leaves(params)
            if p.startswith(prefixes)]
