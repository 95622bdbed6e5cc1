"""Caffe graph interpreter (`redtail_tpu/models/caffe_net.py`): a parsed
prototxt run as an `nn.Module`.

It replaces the reference's `TensorNet` engine path
(`ros/packages/caffe_ros/src/tensor_net.cpp:79-180`: NvCaffeParser ->
TensorRT engine). The layer set covers the two shipped inference graphs
(TrailNet's SResNet-18 and `yolo-relu.prototxt`): Convolution, Pooling
(MAX / AVE with Caffe's ceil-mode arithmetic, global pooling), ReLU (leaky
too), Scale (learned, or the prototxt's filler constants: TrailNet's
sub_mean and the SReLU shift pair), BatchNorm (global stats), Eltwise
(SUM / PROD / MAX), InnerProduct, Softmax, Concat, Power, Dropout and Input
(inference no-ops). Train-phase layers are skipped.

Blobs are NCHW, Caffe's own layout, so Caffe's channel axis 1 and its
InnerProduct flattening order hold as they are; `forward`'s dict holds
every blob so (4D blobs NCHW, 2D blobs (N, C)). The input is NHWC or NCHW,
told apart as the JAX interpreter does. Numerics are the JAX
interpreter's: convolutions and inner products sum in fp32 with an fp32
bias and round once to the net's dtype (`ops/convolution.py:
conv2d_round_once`), Scale, BatchNorm and Eltwise run in the net's dtype.
No CUDA kernel of the port lies on this path: the convolutions are
cuDNN's, the rest stock PyTorch.

Random weights (no caffemodel, for structural testing) are drawn as the
JAX interpreter draws them, number for number: one
`np.random.RandomState(seed)` in layer order, and each InnerProduct's at
its first forward (its fan-in is known then) from its own stream.
"""

from __future__ import annotations

import math
import zlib
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from redtail_tpu_torch import resolve_device
from redtail_tpu_torch.io.caffe import Msg
from redtail_tpu_torch.ops.convolution import conv2d_round_once, linear_fp32


def _as_pair(param: Msg, base: str):
    """Caffe's kernel_size/stride/pad fields: scalar, repeated, or _h/_w.

    The anisotropic names drop any ``_size`` suffix (Caffe proto:
    ``kernel_size`` vs ``kernel_h``/``kernel_w``)."""
    stem = base[:-5] if base.endswith("_size") else base
    h = param.get(stem + "_h")
    w = param.get(stem + "_w")
    if h is not None or w is not None:
        return int(h), int(w)
    vals = param.get_all(base)
    if not vals:
        return None
    if len(vals) == 1:
        return int(vals[0]), int(vals[0])
    return int(vals[0]), int(vals[1])


def _pool_out_dim(size: int, k: int, s: int, pad: int) -> int:
    """Caffe's pooled size: ceil mode, and the clip rule (the last window
    starts strictly inside the padded input), which Caffe applies only
    when pad > 0."""
    o = int(math.ceil((size + 2 * pad - k) / s)) + 1
    if pad > 0 and (o - 1) * s >= size + pad:
        o -= 1
    return o


def _ave_pool_counts(size: int, k: int, s: int, pad: int) -> np.ndarray:
    """Caffe's AVE divisor along one axis: the window clipped to the padded
    extent, so padded cells count and the ceil-mode cells past it do not."""
    start = np.arange(_pool_out_dim(size, k, s, pad)) * s
    return np.maximum(np.minimum(start + k, size + 2 * pad) - start, 0)


def _channels(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A per-channel blob (C,) shaped to broadcast over x's axis 1."""
    return t if t.dim() == 0 else t.reshape(-1, *[1] * (x.dim() - 2))


class CaffeNet(nn.Module):
    """Executable network built from a parsed prototxt.

    ``net.params`` is the host weight dict (layer name -> list of numpy
    blobs, Caffe blob order, a random-weight InnerProduct a placeholder
    until the first forward), as the JAX interpreter's; the module holds
    the device copies. Weights come from ``weights`` (the JAX package's
    blob dict, e.g. a parsed caffemodel or `native_params_to_blobs`) where
    it names a layer, else from the prototxt's fillers and ``seed``.
    ``device``: ``None`` is the card; ``"cpu"`` runs on the CPU."""

    SUPPORTED = {"Convolution", "Pooling", "ReLU", "Scale", "BatchNorm",
                 "Eltwise", "InnerProduct", "Softmax", "Concat", "Dropout",
                 "Input", "Power"}

    def __init__(self, net: Msg, weights: Optional[Dict[str, List]] = None,
                 *, seed: int = 0, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.net = net
        self.dtype = dtype
        self.layers = [l for l in net.get_all("layer")
                       if self._in_deploy(l)]
        for l in self.layers:
            t = l.get("type")
            if t not in self.SUPPORTED:
                raise NotImplementedError(f"Caffe layer type {t!r}")
        self.input_names, self.input_shapes = self._parse_inputs(net)
        # tracks the module's device through `.to()`; the blobs are buffers
        self.register_buffer("_anchor",
                             torch.empty(0, device=resolve_device(device)),
                             persistent=False)
        self._types = {l.get("name"): l.get("type") for l in self.layers}
        self._buffers_of: Dict[str, List[str]] = {}
        self._n_blobs = 0
        self._counts: Dict[tuple, torch.Tensor] = {}
        self.params = self._init_params(weights, seed)
        for name, blobs in self.params.items():
            if not isinstance(blobs[0], tuple):
                self._upload(name, blobs)

    @property
    def device(self) -> torch.device:
        return self._anchor.device

    @staticmethod
    def _in_deploy(layer: Msg) -> bool:
        # Skip train-phase-only layers (include.phase: TRAIN).
        for inc in layer.get_all("include"):
            if inc.get("phase") == "TRAIN":
                return False
        return True

    @staticmethod
    def _parse_inputs(net: Msg):
        names = [n for n in net.get_all("input")]
        shapes = []
        for shp in net.get_all("input_shape"):
            shapes.append([int(d) for d in shp.get_all("dim")])
        dims = net.get_all("input_dim")
        if dims:
            shapes = [[int(d) for d in dims[i:i + 4]]
                      for i in range(0, len(dims), 4)]
        return names, shapes  # shapes are NCHW

    # ------------------------------------------------------------ weights

    def _init_params(self, weights, seed):
        rng = np.random.RandomState(seed)
        params: Dict[str, list] = {}
        # Track channel counts through the graph to size random weights.
        chans: Dict[str, int] = {}
        for name, shape in zip(self.input_names, self.input_shapes):
            chans[name] = shape[1]
        for l in self.layers:
            t = l.get("type")
            name = l.get("name")
            bottoms = l.get_all("bottom")
            tops = l.get_all("top")
            cin = chans.get(bottoms[0]) if bottoms else None
            cout = cin
            blobs: list = []
            if t == "Convolution":
                p = l.get("convolution_param")
                cout = int(p.get("num_output"))
                kh, kw = _as_pair(p, "kernel_size")
                if weights and name in weights:
                    blobs = [np.asarray(b) for b in weights[name]]
                else:
                    fan_in = cin * kh * kw
                    blobs = [rng.randn(cout, cin, kh, kw).astype(np.float32)
                             * math.sqrt(2.0 / fan_in)]
                    if p.get("bias_term", True):
                        blobs.append(np.zeros(cout, np.float32))
            elif t == "InnerProduct":
                p = l.get("inner_product_param")
                cout = int(p.get("num_output"))
                if weights and name in weights:
                    blobs = [np.asarray(b) for b in weights[name]]
                else:
                    # drawn at the first forward, when the fan-in is known
                    blobs = [("lazy_ip", cout, seed)]
            elif t == "Scale":
                p = l.get("scale_param") or Msg()
                if weights and name in weights:
                    blobs = [np.asarray(b) for b in weights[name]]
                else:
                    filler = p.get("filler")
                    if filler is not None and "value" in filler:
                        blobs = [np.float32(filler.get("value"))]
                    else:
                        blobs = [np.ones(cin, np.float32)]
                    if p.get("bias_term", False):
                        bf = p.get("bias_filler")
                        if bf is not None and "value" in bf:
                            blobs.append(np.float32(bf.get("value")))
                        else:
                            blobs.append(np.zeros(cin, np.float32))
            elif t == "BatchNorm":
                if weights and name in weights:
                    blobs = [np.asarray(b) for b in weights[name]]
                else:
                    blobs = [np.zeros(cin, np.float32),
                             np.ones(cin, np.float32),
                             np.ones(1, np.float32)]
            elif t == "Concat":
                cout = sum(chans[b] for b in bottoms)
            elif t == "Eltwise":
                cout = chans[bottoms[0]]
            if blobs:
                params[name] = blobs
            for top in tops:
                chans[top] = cout
        return params

    def _upload(self, name: str, blobs: list) -> None:
        """Device copies of a layer's blobs, in the dtypes the JAX
        interpreter computes them in: conv and inner-product weights and
        Scale blobs in the net's dtype, their biases in fp32, BatchNorm's
        scaled mean and variance in fp32 and then the net's dtype."""
        t = self._types[name]
        host = [torch.as_tensor(np.asarray(b, np.float32)) for b in blobs]
        if t == "Convolution":
            p = next(l for l in self.layers
                     if l.get("name") == name).get("convolution_param")
            kh, kw = _as_pair(p, "kernel_size")
            w = host[0].reshape(host[0].shape[0], -1, kh, kw)
            dev = [w.to(self.dtype)] + host[1:2]
        elif t == "InnerProduct":
            w = host[0]
            if w.dim() == 4:  # legacy (1, 1, out, in) blob shape
                w = w.reshape(w.shape[-2], w.shape[-1])
            dev = [w.to(self.dtype)] + host[1:2]
        elif t == "Scale":
            dev = [b.to(self.dtype) for b in host[:2]]
        else:  # BatchNorm: mean, var, scale factor
            mean, var, sf = host[:3]
            scale = 1.0 / torch.clamp_min(sf.reshape(-1)[0], 1e-30)
            dev = [(mean * scale).to(self.dtype), (var * scale).to(self.dtype)]
        names = []
        for b in dev:
            key = f"_blob{self._n_blobs}"
            self._n_blobs += 1
            self.register_buffer(key, b.to(self.device))
            names.append(key)
        self._buffers_of[name] = names

    def _blobs(self, name: str) -> List[torch.Tensor]:
        return [getattr(self, key) for key in self._buffers_of[name]]

    # ------------------------------------------------------------ forward

    def input_blobs(self, inputs) -> Dict[str, torch.Tensor]:
        """The input blobs, NCHW on the net's device in its dtype, from an
        array or tensor, or a dict name -> array; NCHW or NHWC (NCHW where
        C == the input_shape's C and the last axis is not)."""
        if not isinstance(inputs, dict):
            inputs = {self.input_names[0]: inputs}
        blobs: Dict[str, torch.Tensor] = {}
        for name, shape in zip(self.input_names, self.input_shapes):
            x = torch.as_tensor(inputs[name]).to(self.device, self.dtype)
            if x.dim() == 3:
                x = x[None]
            if not (x.shape[1] == shape[1] and x.shape[3] != shape[1]):
                x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
            blobs[name] = x
        return blobs

    def forward(self, inputs) -> Dict[str, torch.Tensor]:
        """Run the graph (``inputs`` as `input_blobs` takes them). Returns
        every blob (NCHW) plus '__out__', the last layer's top. Each layer
        runs through `_layer`, which `quant.caffe_net_forward_int8` calls
        for every layer it does not run in int8."""
        blobs = self.input_blobs(inputs)
        last_top = None
        for l in self.layers:
            t = l.get("type")
            name = l.get("name")
            bottoms = [blobs[b] for b in l.get_all("bottom")]
            out = self._layer(t, name, l, bottoms)
            for top in l.get_all("top"):
                blobs[top] = out
                last_top = top
        blobs["__out__"] = blobs[last_top]
        return blobs

    def __call__(self, inputs) -> torch.Tensor:
        """The last layer's top (the JAX interpreter's ``net(x)``)."""
        return super().__call__(inputs)["__out__"]

    def _layer(self, t, name, l, bottoms):
        x = bottoms[0] if bottoms else None
        if t == "ReLU":
            slope = (l.get("relu_param") or Msg()).get("negative_slope", 0.0)
            return torch.where(x > 0, x, slope * x) if slope \
                else torch.relu(x)
        if t == "Convolution":
            return self._conv(l, x, self._blobs(name))
        if t == "Pooling":
            return self._pool(l, x)
        if t == "Scale":
            # y = x * s (+ b), each step rounded in the net's dtype
            s, *b = self._blobs(name)
            out = x * _channels(s, x)
            return out + _channels(b[0], x) if b else out
        if t == "BatchNorm":
            m, v = self._blobs(name)
            eps = (l.get("batch_norm_param") or Msg()).get("eps", 1e-5)
            return (x - _channels(m, x)) * torch.rsqrt(_channels(v, x) + eps)
        if t == "Eltwise":
            op = (l.get("eltwise_param") or Msg()).get("operation", "SUM")
            combine = {"SUM": torch.add, "PROD": torch.mul,
                       "MAX": torch.maximum}.get(op)
            if combine is None:
                raise NotImplementedError(f"Eltwise {op}")
            out = bottoms[0]
            for b in bottoms[1:]:
                out = combine(out, b)
            return out
        if t == "InnerProduct":
            return self._inner_product(name, x)
        if t == "Softmax":
            # jax.nn.softmax's steps, each rounded in the net's dtype
            axis = (l.get("softmax_param") or Msg()).get("axis", 1)
            e = torch.exp(x - x.amax(dim=axis, keepdim=True))
            return e / e.sum(dim=axis, keepdim=True)
        if t == "Concat":
            axis = (l.get("concat_param") or Msg()).get("axis", 1)
            return torch.cat(bottoms, dim=axis)
        if t == "Power":
            p = l.get("power_param") or Msg()
            power = p.get("power", 1.0)
            scale = p.get("scale", 1.0)
            shift = p.get("shift", 0.0)
            out = scale * x + shift
            return out if power == 1.0 else out ** power
        if t in ("Dropout", "Input"):
            return x
        raise NotImplementedError(t)

    def _conv(self, l, x, blobs):
        p = l.get("convolution_param")
        stride = _as_pair(p, "stride") or (1, 1)
        pad = _as_pair(p, "pad") or (0, 0)
        return conv2d_round_once(x, blobs[0], blobs[1] if len(blobs) > 1
                                 else None, stride, pad)

    def _pool(self, l, x):
        p = l.get("pooling_param")
        mode = p.get("pool", "MAX")
        h, w = x.shape[2], x.shape[3]
        if p.get("global_pooling", False):
            kh, kw = h, w
            sh = sw = 1
            ph = pw = 0
        else:
            kh, kw = _as_pair(p, "kernel_size")
            sh, sw = _as_pair(p, "stride") or (1, 1)
            ph, pw = _as_pair(p, "pad") or (0, 0)
        oh, ow = _pool_out_dim(h, kh, sh, ph), _pool_out_dim(w, kw, sw, pw)
        # end pads that make floor-mode pooling take Caffe's ceil windows
        hi_h = max(0, (oh - 1) * sh + kh - h - ph)
        hi_w = max(0, (ow - 1) * sw + kw - w - pw)
        if mode == "MAX":
            xp = F.pad(x, (pw, hi_w, ph, hi_h), value=-math.inf)
            return F.max_pool2d(xp, (kh, kw), (sh, sw))
        # AVE: the window sums in the net's dtype, added in the window's
        # row-major order (the JAX interpreter's reduce_window, whose sum is
        # in its input's dtype), over the counts Caffe divides by
        xp = F.pad(x, (pw, hi_w, ph, hi_h))
        sums = None
        for i in range(kh):
            for j in range(kw):
                tap = xp[:, :, i:i + (oh - 1) * sh + 1:sh,
                         j:j + (ow - 1) * sw + 1:sw]
                sums = tap if sums is None else sums + tap
        key = (h, w, kh, kw, sh, sw, ph, pw, x.device, x.dtype)
        if key not in self._counts:
            counts = np.outer(_ave_pool_counts(h, kh, sh, ph),
                              _ave_pool_counts(w, kw, sw, pw))
            self._counts[key] = torch.as_tensor(
                counts, dtype=torch.float32).to(x.device, x.dtype)
        return sums / self._counts[key]

    def _inner_product(self, name, x):
        blobs = self.params[name]
        if isinstance(blobs[0], tuple) and blobs[0][0] == "lazy_ip":
            _tag, cout, seed = blobs[0]
            fan_in = int(np.prod(x.shape[1:]))
            # a per-layer stream stable across processes (Python's hash()
            # is salted per process)
            rng = np.random.RandomState(seed ^ (zlib.crc32(name.encode())
                                                & 0xFFFF))
            w = rng.randn(cout, fan_in).astype(np.float32) \
                * math.sqrt(1.0 / fan_in)
            self.params[name] = [w, np.zeros(cout, np.float32)]
            self._upload(name, self.params[name])
        w, *b = self._blobs(name)
        # NCHW flattens in Caffe's order
        out = linear_fp32(x.reshape(x.shape[0], -1), w, b[0] if b else None)
        return out.to(self.dtype)
