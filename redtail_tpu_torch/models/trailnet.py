"""TrailNet SResNet-18 (`redtail_tpu/models/trailnet.py`): the trail
orientation and lateral-offset classifier the controller steers on.

Two implementations, held against each other and against the JAX package's
in the tests:

1. The Caffe-graph path: `load_trailnet()` runs a TrailNet prototxt through
   the `CaffeNet` interpreter, as the reference's `caffe_ros` node did
   (weights from a caffemodel when given). `DEFAULT_PROTOTXT` names the
   reference's shipped graph, which this repository does not hold: pass
   `parse_prototxt(emit_trailnet_prototxt())` (`models/trailnet_proto.py`,
   the same topology) to `CaffeNet` instead.
2. The native `TrailNet` module (conv1 + pool, 4 x 2 residual blocks with
   the shifted ReLU, avg-pool, dual 3-way heads) and `trailnet_forward`.

Output contract (`caffe_ros.cpp:128-154`): 6 floats, the softmax over 3
orientation classes (left / center / right of the trail) then the softmax
over 3 lateral-offset classes. With ``return_logits`` the native forward
returns the two heads' fp32 logits instead (the training path).

Weights carry across packages as the JAX package's native tree
``{layer: {"w": HWIO (fc: (in, out)), "b": (out,)}}`` of numpy arrays
(`params_from_numpy` / `params_to_numpy`), and as the w8 npz artifact
(`params_to_w8_npz` / `params_from_w8_npz`, the same keys and layout).
Convolutions sum in fp32 and round once (`ops/convolution.py:
conv2d_round_once`), as JAX's do. No CUDA kernel of the port lies on this
path: the convolutions are cuDNN's, the rest stock PyTorch.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from redtail_tpu_torch import resolve_device
from redtail_tpu_torch.io.caffe import load_caffemodel, load_prototxt
from redtail_tpu_torch.models.caffe_net import CaffeNet
from redtail_tpu_torch.ops.activations import srelu
from redtail_tpu_torch.ops.convolution import conv2d_round_once, linear_fp32
from redtail_tpu_torch.quant.ptq import quantize_per_channel

DEFAULT_PROTOTXT = Path(
    "/root/reference/models/pretrained/TrailNet_SResNet-18.prototxt")

INPUT_HW = (180, 320)  # rows, cols (`TrailNet_SResNet-18.prototxt:1-7`)

_BLOCKS = (2, 2, 2, 2)
# Shipped SResNet-18 widths (`TrailNet_SResNet-18.prototxt`: conv1
# num_output 64, res1 64, res2 128, res3 256, res4 512).
_CHANNELS = (64, 128, 256, 512)
_HEADS = ("fc3", "fc3_t")

Params = Dict[str, Dict[str, np.ndarray]]


def load_trailnet(prototxt_path=DEFAULT_PROTOTXT, caffemodel_path=None, *,
                  seed: int = 0, dtype: torch.dtype = torch.float32,
                  device=None) -> CaffeNet:
    """The TrailNet graph executor from a prototxt file (and caffemodel).
    ``device``: ``None`` is the card."""
    weights = None
    if caffemodel_path is not None:
        weights = load_caffemodel(caffemodel_path)
    return CaffeNet(load_prototxt(prototxt_path), weights, seed=seed,
                    dtype=dtype, device=device)


def trailnet_predict(net, image_bgr_255) -> torch.Tensor:
    """Raw 0-255 BGR frame(s), (H, W, 3) or (N, H, W, 3) -> (N, 6)
    probabilities. The graph's sub_mean Scale layer applies the 1/256,
    -0.5 normalization (the reference feeds scale 1, shift 0,
    `caffe_ros.cpp:51-52`). ``net``: a `CaffeNet` or a `TrailNet`."""
    x = torch.as_tensor(image_bgr_255).to(net.device, net.dtype)
    if x.dim() == 3:
        x = x[None]
    return net(x)


# ----------------------------------------------------------- native model


def _layer_shapes():
    """(name, kernel shape (HWIO, fc (in, out))) of the native tree, in the
    shipped topology's order: conv names = prototxt layer names."""
    shapes = [("conv1", (7, 7, 3, _CHANNELS[0]))]
    cin = _CHANNELS[0]
    for stage, (nblocks, cout) in enumerate(zip(_BLOCKS, _CHANNELS), 1):
        for blk in range(1, nblocks + 1):
            stride_block = stage > 1 and blk == 1
            shapes.append((f"res{stage}_{blk}_1", (3, 3, cin, cout)))
            shapes.append((f"res{stage}_{blk}_2", (3, 3, cout, cout)))
            if stride_block or cin != cout:
                shapes.append((f"res{stage}_{blk}_proj", (1, 1, cin, cout)))
            cin = cout
    shapes += [(head, (cin, 3)) for head in _HEADS]
    return shapes


def init_trailnet_params(seed: int = 0) -> Params:
    """Random native tree (He-init convs, fc at sqrt(1 / fan-in), zero
    biases) drawn from a `torch.Generator` seeded with ``seed``; its numbers
    differ from `jax.random`'s, so tests carry weights across instead."""
    gen = torch.Generator().manual_seed(int(seed))
    params: Params = {}
    for name, shape in _layer_shapes():
        gain = 2.0 if len(shape) == 4 else 1.0
        fan_in = int(np.prod(shape[:-1]))
        w = torch.randn(shape, generator=gen) * math.sqrt(gain / fan_in)
        params[name] = {"w": w.numpy(), "b": np.zeros(shape[-1], np.float32)}
    return params


class TrailNet(nn.Module):
    """Native SResNet-18: (N, 180, 320, 3) raw 0-255 NHWC -> (N, 6).

    Mirrors the shipped prototxt op for op: sub_mean (1/256, -0.5) ->
    conv1 7x7 s2 pad 0 -> max-pool 3x3 s2 (Caffe ceil mode) -> 4 stages of
    2 residual blocks with SReLU (the stride 2 on the second conv of each
    stage's first block, with a 1x1 s2 projection shortcut) -> 10x6 AVE
    pool (global at 320x180) -> fc3 / fc3_t -> softmax each -> concat.
    Parameters (``weight`` OIHW / (out, in), ``bias``) are trainable and
    held in ``dtype``; the input is cast to it."""

    def __init__(self, params: Params, *, device: torch.device,
                 dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.ParameterDict()
        self.bias = nn.ParameterDict()
        for name, shape in _layer_shapes():
            w = np.asarray(params[name]["w"], np.float32)
            if w.shape != shape:
                raise ValueError(f"{name}: weight shape {w.shape}, TrailNet "
                                 f"wants {shape}")
            w = np.transpose(w, (3, 2, 0, 1) if w.ndim == 4 else (1, 0))
            for store, a in ((self.weight, w), (self.bias, params[name]["b"])):
                # a copy: on the CPU the parameters would otherwise alias
                # the caller's arrays, which training updates in place
                store[name] = nn.Parameter(torch.from_numpy(
                    np.array(a, np.float32)).to(device, dtype))

    @property
    def device(self) -> torch.device:
        return self.weight["conv1"].device

    def _c2d(self, name: str, x: torch.Tensor, stride: int = 1,
             pad: Optional[int] = None) -> torch.Tensor:
        # Caffe convolution: explicit symmetric pad (default k // 2), floor
        # output dims (not TF-SAME)
        w = self.weight[name]
        pad = w.shape[-1] // 2 if pad is None else pad
        return conv2d_round_once(x, w, self.bias[name], stride, (pad, pad))

    def forward(self, x: torch.Tensor, *, return_logits: bool = False
                ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        x = x.to(self.device, self.dtype).permute(0, 3, 1, 2)
        x = x * (1.0 / 256.0) - 0.5
        x = srelu(self._c2d("conv1", x, 2, pad=0))
        # Caffe's ceil-mode 3x3 s2 max-pool: end-pad so floor mode takes the
        # same windows
        h, w = x.shape[2:]
        eh = max(0, math.ceil((h - 3) / 2) * 2 + 3 - h)
        ew = max(0, math.ceil((w - 3) / 2) * 2 + 3 - w)
        x = F.max_pool2d(F.pad(x, (0, ew, 0, eh), value=-math.inf), 3, 2)
        for stage, nblocks in enumerate(_BLOCKS, 1):
            for blk in range(1, nblocks + 1):
                stride = 2 if (stage > 1 and blk == 1) else 1
                base = f"res{stage}_{blk}"
                res = srelu(self._c2d(f"{base}_1", x))
                res = self._c2d(f"{base}_2", res, stride)
                shortcut = (self._c2d(f"{base}_proj", x, stride, pad=0)
                            if f"{base}_proj" in self.weight else x)
                x = srelu(res + shortcut)
        # pool_avg: kernel 10 x 6, stride 1, global only at the canonical
        # input; refuse other sizes rather than diverge from the graph
        if tuple(x.shape[2:]) != (6, 10):
            raise ValueError(
                f"trailnet_forward: trunk output {tuple(x.shape[2:])} != "
                f"(6, 10); the shipped 10x6 AVE pool requires {INPUT_HW} "
                "input (resize frames first)")
        x = x.mean(dim=(2, 3))
        logits = [linear_fp32(x, self.weight[h], self.bias[h])
                  for h in _HEADS]
        if return_logits:
            return logits[0], logits[1]
        return torch.cat([F.softmax(z, dim=-1) for z in logits],
                         dim=-1).to(self.dtype)


def params_from_numpy(params: Params, *, device=None,
                      dtype: torch.dtype = torch.float32) -> TrailNet:
    """`TrailNet` from the JAX package's native tree of numpy arrays.
    ``device=None`` is the card (see `resolve_device`)."""
    return TrailNet(params, device=resolve_device(device), dtype=dtype)


def params_to_numpy(net: TrailNet) -> Params:
    """The inverse of `params_from_numpy`: the native tree (HWIO convs,
    (in, out) fc) as float32 numpy."""
    out: Params = {}
    for name, w in net.weight.items():
        w = w.detach().float().cpu()
        w = w.permute(2, 3, 1, 0) if w.dim() == 4 else w.t()
        # copies: a CPU net's arrays would otherwise alias its parameters
        out[name] = {"w": w.numpy().copy(),
                     "b": net.bias[name].detach().float().cpu().numpy()
                     .copy()}
    return out


def trailnet_forward(params, x: torch.Tensor, *, return_logits: bool = False):
    """Counterpart of the JAX `trailnet_forward`: (N, 180, 320, 3) raw
    0-255 NHWC -> (N, 6) probabilities, or the (fc3, fc3_t) fp32 logits.
    ``params``: a `TrailNet`, or a native numpy tree built here on x's
    device in x's dtype."""
    net = params if isinstance(params, TrailNet) else TrailNet(
        params, device=x.device, dtype=x.dtype)
    return net(x, return_logits=return_logits)


# ----------------------------------------------------- weight artifacts


def params_to_w8_npz(params, path) -> None:
    """Save a native tree (or a `TrailNet`) as per-channel int8 weights +
    fp32 scales and biases: `<layer>/w_q` int8, `<layer>/w_scale` fp32
    (c_out,), `<layer>/b` fp32, the JAX package's artifact layout."""
    if isinstance(params, TrailNet):
        params = params_to_numpy(params)
    flat = {}
    for name, node in params.items():
        wq, scale = quantize_per_channel(np.asarray(node["w"], np.float32),
                                         axis=-1)
        flat[f"{name}/w_q"] = wq
        flat[f"{name}/w_scale"] = np.asarray(scale, np.float32).reshape(-1)
        flat[f"{name}/b"] = np.asarray(node["b"], np.float32)
    np.savez(path, **flat)


def params_from_w8_npz(path) -> Params:
    """A `params_to_w8_npz` artifact as a native tree of float32 numpy
    (dequantized as the JAX loader does); `params_from_numpy` builds the
    module in the serving dtype."""
    params: Params = {}
    with np.load(path) as data:
        names = sorted({k.rsplit("/", 1)[0] for k in data.files})
        for name in names:
            w = (data[f"{name}/w_q"].astype(np.float32)
                 * data[f"{name}/w_scale"])
            params[name] = {"w": w, "b": data[f"{name}/b"]}
    return params
