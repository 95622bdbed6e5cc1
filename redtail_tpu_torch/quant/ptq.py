"""Post-training quantization (`redtail_tpu/quant/ptq.py`).

What TensorRT's INT8 builder and the reference's `Int8EntropyCalibrator`
(`int8_calibrator.cpp:49-110`) provided, as in the JAX package:

1. **Calibration**: a clipping threshold per activation tensor, from KL
   divergence (entropy), a percentile or the maximum of |x|, over samples
   the `CalibrationCollector` gathers (numpy, the JAX package's arithmetic
   step for step).
2. **Weights**: symmetric per-output-channel int8 (`quantize_per_channel`),
   and the weight-only rung `w8`, dequantized once at load
   (`quantize_stereo_params_w8`, `dequantize_tree`).
3. **Execution**: `conv2d_int8`, int8 activations x int8 weights with an
   exact integer sum, then dequantized as JAX does: ``acc_f32 * (x_scale *
   w_scale)``, ``+ bias``, one cast. JAX leaves the int32 conv to XLA;
   here it is stock PyTorch, on one of two exact routes. Where
   ``K * 127**2 < 2**24`` (K = kh * kw * C_in) the conv runs in fp32 on
   fp32 carriers of the int8 values, TF32 allowed: every |q| <= 127 is a
   TF32 value, every product and partial sum an integer below 2**24, so
   any summation order gives the exact sum, as long as cuDNN sums the
   products themselves (a direct or implicit-GEMM algorithm; a Winograd
   or FFT one would transform the operands first). `chip_smoke.py` 8c
   holds every stereo int8 layer at full size bit-equal to the int32
   route on the card, where this route is also the faster (PERF.md §6).
   Above the bound, im2col and `torch._int_mm` sum in int32 (on the card
   the rows padded with zeros to a multiple of 32 and K and N to
   multiples of 8: cuBLASLt's int8 product refuses some other shapes).
   A route that fails on the card raises: nothing falls back to fp32.

`calibrate_caffe_net` and `caffe_net_forward_int8` run the Caffe
interpreter's graphs (TrailNet, YOLO) through the int8 convs; the stereo
rungs are `quant/stereo_int8.py`.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from redtail_tpu_torch.ops.convolution import (_conv, _tf32, _tuple,
                                               tf_same_padding)

# The largest K = kh * kw * C_in whose int8 sums stay exact in fp32:
# K * 127**2 < 2**24.
EXACT_FP32_K = ((1 << 24) - 1) // (127 * 127)

Padding = Union[str, Sequence[Tuple[int, int]]]


# ----------------------------------------------------------- calibration


def entropy_threshold(samples: np.ndarray, num_bins: int = 2048,
                      target_bins: int = 128) -> float:
    """KL-optimal |x| clipping threshold (TensorRT entropy calibration).

    Builds a |x| histogram and evaluates, for each candidate threshold i,
    the KL divergence between the clipped reference distribution P and its
    int8 re-quantization Q; returns the threshold minimizing KL.
    """
    samples = np.abs(np.asarray(samples, np.float64).reshape(-1))
    amax = float(samples.max()) if samples.size else 0.0
    if amax == 0.0:
        return 1e-8
    hist, edges = np.histogram(samples, bins=num_bins, range=(0, amax))
    hist = hist.astype(np.float64)
    best_kl = np.inf
    best_i = num_bins
    for i in range(target_bins, num_bins + 1, 8):
        p = hist[:i].copy()
        p[-1] += hist[i:].sum()  # clipped outlier mass -> last bin of P
        if p.sum() == 0:
            continue
        # Q: the int8 projection of the unclipped section, hist[:i] in
        # target_bins buckets expanded back over p's support (a Q built
        # from the outlier-augmented P makes KL(P||Q) = 0 at every i)
        chunks = np.array_split(hist[:i], target_bins)
        q = np.concatenate([
            np.full(len(c), c.sum() / max((c > 0).sum(), 1))
            * (c > 0) for c in chunks])
        p_n = p / p.sum()
        q_n = q / max(q.sum(), 1e-30)
        mask = p_n > 0
        kl = float(np.sum(p_n[mask] *
                          np.log(p_n[mask] / np.maximum(q_n[mask], 1e-30))))
        if kl < best_kl:
            best_kl = kl
            best_i = i
    return float(edges[best_i])


def amax_threshold(samples: np.ndarray, percentile: float = 100.0) -> float:
    samples = np.abs(np.asarray(samples).reshape(-1))
    if samples.size == 0:
        return 1e-8
    if percentile >= 100.0:
        return float(samples.max())
    return float(np.percentile(samples, percentile))


class CalibrationCollector:
    """Accumulates per-tensor activation samples across calibration
    batches, then yields scales (the calibrator's getBatch loop).

    Methods: ``"entropy"`` (TRT's KL calibration, for trained nets),
    ``"percentile"`` (clip at a high |x| percentile, the robust choice for
    random-weight nets), ``"max"`` (no clipping). ``observe`` takes numpy
    in the JAX package's NHWC order: the subsample depends on it."""

    def __init__(self, method: str = "entropy", max_samples: int = 1 << 20,
                 percentile: float = 99.99):
        if method not in ("entropy", "percentile", "max"):
            raise ValueError(f"unknown calibration method {method!r}; "
                             "expected 'entropy', 'percentile', or 'max'")
        self.method = method
        self.max_samples = max_samples
        self.percentile = percentile
        self._samples: Dict[str, List[np.ndarray]] = {}

    def observe(self, name: str, x) -> None:
        arr = np.abs(np.asarray(x, np.float32).reshape(-1))
        if arr.size > 65536:  # subsample large activations
            arr = arr[:: arr.size // 65536 + 1]
        self._samples.setdefault(name, []).append(arr)

    def scales(self) -> Dict[str, float]:
        out = {}
        for name, chunks in self._samples.items():
            data = np.concatenate(chunks)
            if self.method == "entropy":
                t = entropy_threshold(data)
            elif self.method == "percentile":
                t = amax_threshold(data, self.percentile)
            else:  # "max"
                t = amax_threshold(data)
            out[name] = max(t, 1e-8) / 127.0
        return out


# --------------------------------------------------------------- weights


def quantize_per_channel(w: np.ndarray, axis: int = -1
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-channel int8: returns (int8 values, fp32 scales)."""
    w = np.asarray(w, np.float32)
    reduce_axes = tuple(i for i in range(w.ndim) if i != axis % w.ndim)
    amax = np.abs(w).max(axis=reduce_axes, keepdims=True)
    scale = np.maximum(amax, 1e-8) / 127.0
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)


def dequantize(q: np.ndarray, scale: np.ndarray) -> np.ndarray:
    return q.astype(np.float32) * scale


def _rounded(w: np.ndarray, dtype: Optional[torch.dtype]) -> np.ndarray:
    """``w`` rounded to ``dtype`` and carried as float32 numpy (numpy has
    no bf16); ``w`` as float32 where ``dtype`` is None."""
    w = np.asarray(w, np.float32)
    if dtype is None:
        return w
    return torch.from_numpy(w).to(dtype).float().numpy()


def quantize_stereo_params_w8(params) -> Dict:
    """Weight-only quantization of a stereo param tree: each conv leaf
    becomes {'weights_q', 'w_scale', 'biases'} with per-K scales (the
    last axis of the HWIO / DHWIO kernel)."""
    def q(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict) and "weights" in v:
                wq, sc = quantize_per_channel(np.asarray(v["weights"]),
                                              axis=-1)
                out[k] = {"weights_q": wq, "w_scale": sc,
                          "biases": v["biases"]}
            elif isinstance(v, dict):
                out[k] = q(v)
            else:
                out[k] = v
        return out
    return q(params)


def dequantize_tree(params, dtype: Optional[torch.dtype] = None) -> Dict:
    """Inverse of `quantize_stereo_params_w8`: every {'weights_q',
    'w_scale'} leaf becomes a float 'weights' leaf again, rounded to
    ``dtype`` if given (float32 numpy carrying its values). The one walker
    the serving node and the CLI share."""
    def dq(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict) and "weights_q" in v:
                w = dequantize(np.asarray(v["weights_q"]),
                               np.asarray(v["w_scale"]))
                out[k] = {"weights": _rounded(w, dtype),
                          "biases": v["biases"]}
            elif isinstance(v, dict):
                out[k] = dq(v)
            else:
                out[k] = v
        return out
    return dq(params)


# ------------------------------------------------------------- execution


def _device_scalar(value, like: torch.Tensor) -> torch.Tensor:
    """An fp32 scale as a one-element tensor on ``like``'s device: the
    card's division by a host scalar multiplies by its reciprocal, which
    can differ from JAX's division in the last bit."""
    if isinstance(value, torch.Tensor):
        return value.to(device=like.device, dtype=torch.float32).reshape(1)
    return torch.tensor([np.float32(value)], device=like.device)


def quantize_act(x: torch.Tensor, scale) -> torch.Tensor:
    """clip(round(x / scale), -127, 127) as int8: fp32 division, rounding
    half to even (JAX's `jnp.round`)."""
    q = torch.round(x.float() / _device_scalar(scale, x)).clamp_(-127, 127)
    return q.to(torch.int8)


def _conv_pads(padding: Padding, in_hw, k_hw, stride):
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            return [(0, 0), (0, 0)]
        if padding.upper() != "SAME":
            raise ValueError(f"unknown padding {padding!r}")
        return [tf_same_padding(i, k, s)
                for i, k, s in zip(in_hw, k_hw, stride)]
    return [tuple(int(v) for v in p) for p in padding]


def _pad8(t: torch.Tensor, dim: int) -> torch.Tensor:
    extra = -t.shape[dim] % 8
    if not extra:
        return t
    pad = [0, 0] * (t.dim() - 1 - dim) + [0, extra]
    return F.pad(t, pad)


def _int_mm_conv(x_q: torch.Tensor, w_q: torch.Tensor, stride,
                 pads) -> torch.Tensor:
    """The exact int32 sum of an int8 conv by im2col and `torch._int_mm`:
    x_q (N, C, H, W), w_q (O, C, kh, kw) -> (N, O, H', W') int32."""
    n, c = x_q.shape[:2]
    o, _, kh, kw = w_q.shape
    sh, sw = stride
    xp = F.pad(x_q, [pads[1][0], pads[1][1], pads[0][0], pads[0][1]])
    xp = xp.permute(0, 2, 3, 1)  # NHWC: im2col rows (i, j, c)
    oh = (xp.shape[1] - kh) // sh + 1
    ow = (xp.shape[2] - kw) // sw + 1
    taps = [xp[:, i:i + (oh - 1) * sh + 1:sh, j:j + (ow - 1) * sw + 1:sw]
            for i in range(kh) for j in range(kw)]
    cols = torch.stack(taps, dim=3).reshape(n * oh * ow, kh * kw * c)
    wmat = w_q.permute(2, 3, 1, 0).reshape(kh * kw * c, o)
    m = cols.shape[0]
    if cols.is_cuda:
        # cuBLASLt's int8 product: K and N multiples of 8, and M a
        # multiple of 32 (at small K it refuses some other row counts,
        # e.g. M = 165186 at K = 80)
        cols = _pad8(cols, 1)
        wmat = _pad8(_pad8(wmat, 0), 1)
        cols = F.pad(cols, [0, 0, 0, -m % 32])
    acc = torch._int_mm(cols.contiguous(), wmat.contiguous())[:m, :o]
    return acc.reshape(n, oh, ow, o).permute(0, 3, 1, 2)


def conv2d_int8_acc(x_q: torch.Tensor, w_q: torch.Tensor, *,
                    stride=(1, 1), padding: Padding = "SAME"
                    ) -> torch.Tensor:
    """The exact integer sum of an int8 x int8 conv, as float32 (int32
    rounded to float32 as JAX's ``acc.astype(float32)``): x_q (N, C, H, W),
    w_q (O, C, kh, kw), ``padding`` "SAME" / "VALID" (TF) or explicit
    ((lo, hi), (lo, hi)). The route follows `EXACT_FP32_K`."""
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"conv2d_int8 takes int8 operands, got {x_q.dtype} "
                        f"and {w_q.dtype}")
    stride = _tuple(stride, 2)
    pads = _conv_pads(padding, x_q.shape[2:], w_q.shape[2:], stride)
    k = w_q.shape[1] * w_q.shape[2] * w_q.shape[3]
    if k > EXACT_FP32_K:
        return _int_mm_conv(x_q, w_q, stride, pads).float()
    x = x_q.float()
    if any(lo != hi for lo, hi in pads):
        x = F.pad(x, [pads[1][0], pads[1][1], pads[0][0], pads[0][1]])
        conv_pad = (0, 0)
    else:
        conv_pad = (pads[0][0], pads[1][0])
    with _tf32(x, True):  # every |q| <= 127 is a TF32 value
        return F.conv2d(x, w_q.float(), stride=stride, padding=conv_pad)


def dequantize_acc(acc: torch.Tensor, scale: torch.Tensor,
                   bias: Optional[torch.Tensor],
                   out_dtype: torch.dtype) -> torch.Tensor:
    """JAX's dequant of an (N, K, H, W) fp32 sum: ``acc * scale`` (scale =
    x_scale * w_scale, per K), ``+ bias`` in fp32, one cast."""
    out = acc * scale.reshape(1, -1, 1, 1)
    if bias is not None:
        out = out + bias.float().reshape(1, -1, 1, 1)
    return out.to(out_dtype)


def conv2d_int8_nchw(x_q: torch.Tensor, w_q: torch.Tensor, *, x_scale,
                     w_scale: torch.Tensor,
                     bias: Optional[torch.Tensor] = None, stride=(1, 1),
                     padding: Padding = "SAME",
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """`conv2d_int8` on x_q (N, C, H, W) and w_q (O, C, kh, kw)."""
    scale = _device_scalar(x_scale, x_q) * w_scale.to(
        device=x_q.device, dtype=torch.float32).reshape(-1)
    acc = conv2d_int8_acc(x_q, w_q, stride=stride, padding=padding)
    return dequantize_acc(acc, scale, bias, out_dtype)


def conv2d_int8(x_q: torch.Tensor, w_q: torch.Tensor, *, x_scale, w_scale,
                bias=None, strides=(1, 1), padding: Padding = "SAME",
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """int8 activations x int8 weights -> exact integer sum -> dequant, in
    the JAX function's layouts: ``x_q`` (N, H, W, C) int8, ``w_q`` HWIO
    int8, ``w_scale`` (K,) or broadcastable to it."""
    w_scale = torch.as_tensor(np.asarray(w_scale, np.float32)) \
        if not isinstance(w_scale, torch.Tensor) else w_scale
    if bias is not None and not isinstance(bias, torch.Tensor):
        bias = torch.as_tensor(np.asarray(bias, np.float32),
                               device=x_q.device)
    out = conv2d_int8_nchw(x_q.permute(0, 3, 1, 2), w_q.permute(3, 2, 0, 1),
                           x_scale=x_scale, w_scale=w_scale, bias=bias,
                           stride=strides, padding=padding,
                           out_dtype=out_dtype)
    return out.permute(0, 2, 3, 1)


def conv2d_w8(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
              bias: Optional[torch.Tensor] = None, *, strides=(1, 1),
              padding: str = "SAME") -> torch.Tensor:
    """Weight-only int8 conv (NHWC, HWIO): the weights dequantized in x's
    dtype, then the float conv."""
    w = w_q.to(x.dtype) * w_scale.to(x.dtype)
    out = _conv(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), bias,
                strides, padding)
    return out.permute(0, 2, 3, 1)


# ------------------------------------------------ Caffe-graph INT8 path


def _host_nhwc(x: torch.Tensor) -> np.ndarray:
    """A blob as float32 numpy in the JAX interpreter's layout (4D NCHW ->
    NHWC), which the collector's subsample depends on."""
    if x.dim() == 4:
        x = x.permute(0, 2, 3, 1)
    return x.float().cpu().numpy()


@torch.no_grad()
def calibrate_caffe_net(net, frames, *, method: str = "entropy",
                        percentile: float = 99.99) -> Dict[str, float]:
    """Run calibration frames through a `CaffeNet`, collecting input-
    activation scales for every Convolution/InnerProduct layer.

    Use ``method="percentile"`` for random-weight nets (see
    `CalibrationCollector`); ``"entropy"`` matches the reference's
    `Int8EntropyCalibrator` and is right for trained models."""
    collector = CalibrationCollector(method=method, percentile=percentile)
    conv_layers = [(l.get("name"), l.get_all("bottom")[0])
                   for l in net.layers
                   if l.get("type") in ("Convolution", "InnerProduct")]
    for frame in frames:
        blobs = net.forward(frame)
        for name, bottom in conv_layers:
            collector.observe(name, _host_nhwc(blobs[bottom]))
    return collector.scales()


@torch.no_grad()
def caffe_net_forward_int8(net, inputs, act_scales: Dict[str, float],
                           *, return_blobs: bool = False):
    """Execute a `CaffeNet` with int8 convolutions.

    Convolution layers whose input scale was calibrated run as int8 x int8
    with an exact integer sum (weights quantized per output channel from
    the host fp32 blobs, the fp32 bias, out in the net's dtype); every
    other layer runs as in `CaffeNet.forward`. Returns the last layer's
    top, or every blob (NCHW) with ``return_blobs``."""
    from redtail_tpu_torch.models.caffe_net import _as_pair

    blobs = net.input_blobs(inputs)
    last_top = None
    for l in net.layers:
        t = l.get("type")
        name = l.get("name")
        bottoms = [blobs[b] for b in l.get_all("bottom")]
        if t == "Convolution" and name in act_scales:
            p = l.get("convolution_param")
            kh, kw = _as_pair(p, "kernel_size")
            stride = _as_pair(p, "stride") or (1, 1)
            ph, pw = _as_pair(p, "pad") or (0, 0)
            host = net.params[name]
            w = np.asarray(host[0], np.float32)
            wq, wsc = quantize_per_channel(
                w.reshape(w.shape[0], -1, kh, kw), axis=0)
            xs = act_scales[name]
            dev = net.device
            bias = (torch.as_tensor(np.asarray(host[1], np.float32),
                                    device=dev) if len(host) > 1 else None)
            out = conv2d_int8_nchw(
                quantize_act(bottoms[0], xs), torch.as_tensor(wq,
                                                              device=dev),
                x_scale=xs, w_scale=torch.as_tensor(wsc.reshape(-1)),
                bias=bias, stride=stride, padding=[(ph, ph), (pw, pw)],
                out_dtype=net.dtype)
        else:
            out = net._layer(t, name, l, bottoms)
        for top in l.get_all("top"):
            blobs[top] = out
            last_top = top
    return blobs if return_blobs else blobs[last_top]


# ------------------------------------------------------ calibration cache


def save_calibration(scales: Dict[str, float], path) -> None:
    """Persist calibration scales: the reference's INT8 calibration cache
    (`int8_calibrator.cpp:82-110` writeCalibrationCache) as JSON."""
    Path(path).write_text(json.dumps(scales, indent=2, sort_keys=True))


def load_calibration(path) -> Dict[str, float]:
    return {k: float(v) for k, v in
            json.loads(Path(path).read_text()).items()}


def calibrate_or_load(net, frames, cache_path, *, method: str = "entropy",
                      percentile: float = 99.99) -> Dict[str, float]:
    """Load cached scales if present, else calibrate and write the cache
    (the reference node's readCalibrationCache-or-run-batches flow)."""
    cache = Path(cache_path)
    if cache.exists():
        return load_calibration(cache)
    scales = calibrate_caffe_net(net, frames, method=method,
                                 percentile=percentile)
    save_calibration(scales, cache)
    return scales
