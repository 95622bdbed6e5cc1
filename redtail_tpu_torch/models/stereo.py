"""The stereo model zoo in PyTorch (`redtail_tpu/models/stereo.py`).

All four `STEREO_SPECS` are ported:

- **NVTiny / NVSmall** (plain 2D encoder) and **ResNet-18 3D** (ResNet-18
  encoder): siamese encoder -> concat cost volume at half resolution
  (D = max_disp) and conv3D_1 -> 3D encoder/decoder with skips ->
  soft-argmin over the full-resolution disparity axis (2 * max_disp).
  The output is the expected disparity **in pixels**. By default the
  volume and conv3D_1 are fused (`ops/fused_cost_volume_conv.py`: two
  cuDNN convs and the CUDA assembly kernel on the card); under
  `plain_lowering()` the volume is built explicitly (the CUDA concat
  kernel) and conv3D_1 is a dense conv3d, as the JAX package trains.
- **ResNet18-2D**: siamese ResNet-18 encoder -> correlation cost volume
  (fp32, the CUDA kernel on the card) -> fp32 soft-argmax -> concat with
  the left conv1 features -> 2D bottleneck encoder/decoder -> sigmoid: the
  output is disparity **normalized to [0, 1]** (multiply by the image
  width for pixels).

`StereoNet` is the `nn.Module`; `stereo_forward(spec, params, left, right)`
is the JAX function's counterpart. Weights arrive as the JAX package's
nested param dict of numpy arrays (HWIO / DHWIO, keys as in
`_spec_layer_shapes`) and are moved to PyTorch's layouts once, at load
(`params_from_numpy`), including the space-to-depth form of the stem;
the tree comes from an .npz bundle (`params_from_npz`), a TF checkpoint
(`load_stereo_params`) or a TRT-era weight blob (`params_from_trt_blob`).
A 2D conv leaf may be an int8 leaf of `quant/stereo_int8.py` ({weights_q,
w_scale, x_scale, biases}), run as the JAX package's `_c2d` runs it; an
int8 stem takes only raw frames. Every bf16 conv rounds once, as JAX's
does: the layers hold fp32 carriers of their bf16 weights, made at load
(`ops/convolution.py`).
Activations are NHWC at the public functions and NCHW / NCDHW in
`torch.channels_last` / `torch.channels_last_3d` memory inside.

The 3D models have a second head, the JAX package's accelerator
configuration: under `packed3d_lowering()` (or ``REDTAIL_TPU_PACKED3D=1``,
see `use_packed3d`) the emission kernel writes conv3D_1's output in the
dh-shifted packed layout and the 3D stack runs on D (and H) pairs folded
into channels (`ops/packed3d.py`; its in-shifted, H-packed conv is the CUDA
`conv223` kernel), ending on the card in the D-folded final deconv with the
soft-argmin fused (`ops/convolution.py:conv3d_transpose_dfold`). Its
pad-slot masks take each layer's form from ``REDTAIL_TPU_MASK_FORM`` /
``REDTAIL_TPU_MASK_MUL`` (`_mask_scope`), as JAX's do. Its
band-composed kernels are derived from the same DHWIO weights once, at
load, for each boundary parity an input size can give. The fused unpacked
head stays the default.

The two siamese towers run as one batch-2N chain of convs, which is
exact.

`StereoNet.forward` is `StereoNet.layers(left, right, run)`, the network
one named layer at a time with each layer computed as ``run(name, fn,
*args)``: the forward passes a plain call, the per-layer profiler
(`runtime/layer_profiler.py`) one that records the layer. While a
`torch.profiler` collects, the forward passes one that runs each layer
inside the span of its stage (`layer_stage`): ``stereo/towers``,
``stereo/volume``, ``stereo/enc3d``, ``stereo/dec3d``, ``stereo/head``.

Inside `ops.halo.sharded_axis` the forward runs on one rank's shard
(`parallel/sharding.py`): with H sharded (image mode) each layer works on
its rows, the convs exchanging halos; with D sharded (disparity mode, the
3D models) the 2D towers run whole and the volume, the 3D stack and the
soft-argmin's normalization are split by disparity. The layers are told
the global extent of their inputs (`sharded_extent`), so every TF-SAME pad
and every transposed conv's target is the global one. Image mode runs the
head the lowering in force selects (the fused one, the packed one on its
slots, the plain one) and int8 leaves (the float input's halo rows
exchanged before it is quantized); disparity mode runs the towers whole,
as the JAX package's `_encode_pair` does, and the concat volume and the
3D stack under `plain_lowering()` (`plain_volume_head`).
"""

from __future__ import annotations

import contextlib
import contextvars
import math
import os
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from redtail_tpu_torch import resolve_device
from redtail_tpu_torch.io.tf_checkpoint import load_checkpoint
from redtail_tpu_torch.kernels import conv3d_k3 as K3
from redtail_tpu_torch.kernels import deconv3d_s2 as D2
from redtail_tpu_torch.ops.activations import elu, sigmoid
from redtail_tpu_torch.ops import packed3d as P
from redtail_tpu_torch.ops.convolution import (
    conv2d_nchw,
    conv2d_transpose_nchw,
    conv3d_elu_ncdhw,
    conv3d_ncdhw,
    conv3d_transpose_dfold,
    deconv3d_s2_ncdhw,
    dfold_weights,
    empty_conv_shard,
    plain_lowering,
    sharded_conv_input,
    use_packed3d,
    use_plain_lowering,
)
from redtail_tpu_torch.ops.halo import (
    DISPARITY_AXIS,
    IMAGE_AXIS,
    current_sharding,
    sharded_extent,
)
from redtail_tpu_torch.ops.cost_volume import (
    corr_softargmax_dlast,
    cost_volume,
)
from redtail_tpu_torch.ops.fused_cost_volume_conv import (
    cost_volume_conv3d_nchw,
    split_kernels,
)
from redtail_tpu_torch.ops.softargmax import softargmin
from redtail_tpu_torch.quant.ptq import (conv2d_int8_acc, dequantize_acc,
                                         quantize_act)
from redtail_tpu_torch.ops.space_to_depth import conv5s2_kernel_to_s2d, s2d_hw
from redtail_tpu_torch.runtime.profiler import span, tracing
from redtail_tpu_torch.utils.checkpoint import load_npz_flat

Params = Dict[str, Dict]


# ------------------------------------------------------------------ specs


@dataclass(frozen=True)
class Conv3dLayer:
    name: str
    out_ch: int
    stride: int = 1  # applied to all of (D, H, W)


@dataclass(frozen=True)
class StereoSpec:
    """Static description of one stereo network."""

    name: str
    input_hw: Tuple[int, int]          # (H, W) the reference shipped; any works
    max_disp: int                      # at cost-volume (half) resolution
    encoder2d: str                     # 'plain' (conv1..5) | 'resnet18'
    enc2d_channels: Tuple[int, ...]    # plain encoder channel progression
    enc3d: Tuple[Conv3dLayer, ...] = ()
    dec3d: Tuple[Tuple[str, int, Optional[str]], ...] = ()  # (name, out_ch, skip)
    corr: bool = False
    bneck_channels: Tuple[Tuple[str, int, int], ...] = ()   # (name, out_ch, stride)
    bneck_dec: Tuple[Tuple[str, int, Optional[str]], ...] = ()

    @property
    def full_max_disp(self) -> int:
        return 2 * self.max_disp


def _nvsmall_enc3d(f: int) -> Tuple[Conv3dLayer, ...]:
    """Shared NVTiny/NVSmall 3D encoder, base width f."""
    return (
        Conv3dLayer("conv3D_1", f),
        Conv3dLayer("conv3D_2", f),
        Conv3dLayer("conv3D_3ds", 2 * f, stride=2),
        Conv3dLayer("conv3D_4", 2 * f),
        Conv3dLayer("conv3D_5", 2 * f),
        Conv3dLayer("conv3D_6ds", 4 * f, stride=2),
        Conv3dLayer("conv3D_7", 4 * f),
        Conv3dLayer("conv3D_8", 4 * f),
    )


_RESNET18_ENC3D = (
    Conv3dLayer("conv3D_1a", 32),
    Conv3dLayer("conv3D_1b", 32),
    Conv3dLayer("conv3D_1ds", 64, stride=2),
    Conv3dLayer("conv3D_2a", 64),
    Conv3dLayer("conv3D_2b", 64),
    Conv3dLayer("conv3D_2ds", 64, stride=2),
    Conv3dLayer("conv3D_3a", 64),
    Conv3dLayer("conv3D_3b", 64),
    Conv3dLayer("conv3D_3ds", 64, stride=2),
    Conv3dLayer("conv3D_4a", 64),
    Conv3dLayer("conv3D_4b", 64),
    Conv3dLayer("conv3D_4ds", 128, stride=2),
    Conv3dLayer("conv3D_5a", 128),
    Conv3dLayer("conv3D_5b", 128),
)

STEREO_SPECS: Dict[str, StereoSpec] = {
    # `nvtiny_513x161_net.cpp`: conv5 -> 8ch, cost vol C=16, D=24.
    "nvtiny": StereoSpec(
        name="nvtiny", input_hw=(161, 513), max_disp=24,
        encoder2d="plain", enc2d_channels=(32, 32, 32, 32, 8),
        enc3d=_nvsmall_enc3d(16),
        dec3d=(("deconv3D_1", 32, "conv3D_5"),
               ("deconv3D_2", 16, "conv3D_2"),
               ("deconv3D_3", 1, None)),
    ),
    # `nvsmall_1025x321_net.cpp`: conv5 -> 32ch, cost vol C=64, D=48.
    "nvsmall": StereoSpec(
        name="nvsmall", input_hw=(321, 1025), max_disp=48,
        encoder2d="plain", enc2d_channels=(32, 32, 32, 32, 32),
        enc3d=_nvsmall_enc3d(32),
        dec3d=(("deconv3D_1", 64, "conv3D_5"),
               ("deconv3D_2", 32, "conv3D_2"),
               ("deconv3D_3", 1, None)),
    ),
    # `resnet18_1025x321_net.cpp`: resnet encoder, cost vol C=64, D=68.
    "resnet18": StereoSpec(
        name="resnet18", input_hw=(321, 1025), max_disp=68,
        encoder2d="resnet18", enc2d_channels=(32,),
        enc3d=_RESNET18_ENC3D,
        dec3d=(("deconv3D_1", 64, "conv3D_4b"),
               ("deconv3D_2", 64, "conv3D_3b"),
               ("deconv3D_3", 64, "conv3D_2b"),
               ("deconv3D_4", 32, "conv3D_1b"),
               ("deconv3D_5", 1, None)),
    ),
    # `resnet18_2D_513x257_net.cpp`: correlation cost volume, 2D bottleneck.
    "resnet18_2d": StereoSpec(
        name="resnet18_2d", input_hw=(257, 513), max_disp=48,
        encoder2d="resnet18", enc2d_channels=(32,), corr=True,
        bneck_channels=(("conv2D_1", 32, 1), ("conv2D_2", 32, 1),
                        ("conv2D_3ds", 64, 2), ("conv2D_4", 64, 1),
                        ("conv2D_5", 64, 1), ("conv2D_6ds", 128, 2),
                        ("conv2D_7", 128, 1), ("conv2D_8", 128, 1)),
        bneck_dec=(("deconv2D_1", 64, "conv2D_5"),
                   ("deconv2D_2", 32, "conv2D_2"),
                   ("deconv2D_3", 1, None)),
    ),
}


def _spec_layer_shapes(spec: StereoSpec):
    """(path, kernel_shape_rsck_or_vrsck, bias_shape) for every layer: the
    shape table the reference carried in its generated C++."""
    out = []
    if spec.encoder2d == "plain":
        chans = spec.enc2d_channels
        in_ch = 3
        for i, c in enumerate(chans, start=1):
            k = 5 if i == 1 else 3
            out.append((f"encoder2D/conv{i}", (k, k, in_ch, c), (c,)))
            in_ch = c
        cv_ch = 2 * chans[-1]
    else:
        f = spec.enc2d_channels[0]
        out.append(("encoder2D/conv1", (5, 5, 3, f), (f,)))
        for i in range(1, 9):
            out.append((f"encoder2D/resblock{i}/res_conv1", (3, 3, f, f), (f,)))
            out.append((f"encoder2D/resblock{i}/res_conv2", (3, 3, f, f), (f,)))
        out.append(("encoder2D/encoder2D_out", (3, 3, f, f), (f,)))
        cv_ch = 2 * f
    in_ch = 1 + spec.enc2d_channels[0] if spec.corr else cv_ch
    for layer in spec.enc3d:
        out.append((f"encoder3D/{layer.name}",
                    (3, 3, 3, in_ch, layer.out_ch), (layer.out_ch,)))
        in_ch = layer.out_ch
    for name, out_ch, _skip in spec.dec3d:
        # VRSCK for transpose: C = transpose output channels, K = input.
        out.append((f"decoder3D/{name}", (3, 3, 3, out_ch, in_ch), (out_ch,)))
        in_ch = out_ch
    if spec.bneck_channels:
        in_ch = 1 + spec.enc2d_channels[0]  # softargmax + conv1 features
        for name, out_ch, _stride in spec.bneck_channels:
            out.append((f"bneck_encoder2D/{name}",
                        (3, 3, in_ch, out_ch), (out_ch,)))
            in_ch = out_ch
        for name, out_ch, _skip in spec.bneck_dec:
            out.append((f"bneck_decoder2D/{name}",
                        (3, 3, out_ch, in_ch), (out_ch,)))
            in_ch = out_ch
    return out


# ------------------------------------------------------------- params


def init_stereo_params(spec: StereoSpec, seed: int = 0,
                       dtype=np.float32) -> Params:
    """He-init weights with the spec's exact shapes and zero biases, from
    numpy (`jax.random` cannot be matched), as the JAX package's nested
    param dict."""
    rng = np.random.default_rng(seed)
    params: Params = {}
    for path, kshape, bshape in _spec_layer_shapes(spec):
        fan_in = int(np.prod(kshape[:-1]))
        w = rng.standard_normal(kshape) * math.sqrt(2.0 / fan_in)
        *scopes, name = path.split("/")
        node = params
        for s in scopes:
            node = node.setdefault(s, {})
        node[name] = {"weights": w.astype(dtype),
                      "biases": np.zeros(bshape, dtype)}
    return params


def params_from_npz(path) -> Params:
    """The nested param dict (float32 numpy) of an .npz bundle.

    Takes both key conventions of the JAX package: `model|scope|layer|var`
    (the golden bundles; a 'disp' entry, the bundled golden disparity, is
    skipped) and `scope/layer/var` (`utils/checkpoint.save_params`); of a
    full train state (`params/...` keys) only the params are read.
    ``@bf16`` leaves are decoded without `ml_dtypes`."""
    flat = load_npz_flat(path)
    if any(k.startswith("params/") for k in flat):
        flat = {k[len("params/"):]: v for k, v in flat.items()
                if k.startswith("params/")}
    sep = "|" if any("|" in k for k in flat) else "/"
    params: Params = {}
    for key, arr in flat.items():
        if key == "disp":
            continue
        parts = key.split(sep)
        if parts[0] == "model":
            parts = parts[1:]
        node = params
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return params


def load_stereo_params(checkpoint_prefix) -> Params:
    """The nested param dict (float32 numpy) of a TF checkpoint, e.g. the
    shipped `stereoDNN/models/NVTiny/TensorFlow/model-inference-513x161-0`:
    keys `model/scope/layer/var` split into the tree (a leading `model`
    dropped), read by the numpy-only `io/tf_checkpoint.py`."""
    flat = load_checkpoint(checkpoint_prefix)
    params: Params = {}
    for name, arr in flat.items():
        parts = name.split("/")
        if parts[0] == "model":
            parts = parts[1:]
        node = params
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(arr, np.float32)
    return params


def params_from_trt_blob(spec: StereoSpec,
                         blob: Dict[str, np.ndarray]) -> Params:
    """The nested param dict (float32 numpy) of a TRT-format weight blob
    (`io/trt_weights.py:read_trt_weights`). The blob holds flat arrays
    without shapes (`tensorrt_model_builder.py:52-60`); the shapes come from
    the spec. 2D kernels are stored KCRS and become RSCK, 3D ones KVCRS and
    become VRSCK (for a transposed conv K is its input channels); the
    siamese tower reads the blob's `left_` names. The only way to NVSmall's
    reference weights: its TF checkpoint shipped without data files."""
    params: Params = {}
    for path, kshape, bshape in _spec_layer_shapes(spec):
        layer = path.split("/", 1)[1].replace("/", "_")
        name = "left_" + layer if path.startswith("encoder2D") else layer
        wk, wb = blob[name + "_k"], blob[name + "_b"]
        if len(kshape) == 4:  # KCRS -> RSCK
            r, s_, c, k = kshape
            w = wk.reshape(k, c, r, s_).transpose(2, 3, 1, 0)
        else:  # KVCRS -> VRSCK
            v, r, s_, c, k = kshape
            w = wk.reshape(k, v, c, r, s_).transpose(1, 3, 4, 2, 0)
        if wb.size != int(np.prod(bshape)):
            raise ValueError(f"{name}_b holds {wb.size} values, the spec's "
                             f"{path} bias {bshape}")
        *scopes, leaf = path.split("/")
        node = params
        for scope in scopes:
            node = node.setdefault(scope, {})
        node[leaf] = {"weights": np.ascontiguousarray(w, np.float32),
                      "biases": np.asarray(wb, np.float32).reshape(bshape)}
    return params


def params_to_trt_blob(spec: StereoSpec, params: Params
                       ) -> Dict[str, np.ndarray]:
    """The inverse of `params_from_trt_blob`: the flat name -> array blob of
    a param tree in the reference exporter's layouts (RSCK -> KCRS, VRSCK
    -> KVCRS, the siamese tower under `left_` names), for
    `io.write_trt_weights`."""
    blob = {}
    for path, kshape, _ in _spec_layer_shapes(spec):
        layer = path.split("/", 1)[1].replace("/", "_")
        name = "left_" + layer if path.startswith("encoder2D") else layer
        leaf = params
        for p in path.split("/"):
            leaf = leaf[p]
        perm = (3, 2, 0, 1) if len(kshape) == 4 else (4, 0, 3, 1, 2)
        blob[name + "_k"] = np.transpose(
            np.asarray(leaf["weights"], np.float32), perm).reshape(-1)
        blob[name + "_b"] = np.asarray(leaf["biases"], np.float32)
    return blob


def _tensor(a, device, dtype) -> torch.Tensor:
    # a copy: a trainable net's parameters must not alias the caller's
    # arrays, which the optimizer would otherwise update in place
    t = torch.from_numpy(np.array(a, np.float32)).to(device=device,
                                                       dtype=dtype)
    if t.dim() == 4:
        return t.contiguous(memory_format=torch.channels_last)
    if t.dim() == 5:
        return t.contiguous(memory_format=torch.channels_last_3d)
    return t


def _torch_layout(w: np.ndarray) -> np.ndarray:
    """HWIO / DHWIO -> PyTorch's (O, I, *k); for a transposed conv, whose
    I is its output, that is PyTorch's (in, out, *k)."""
    nd = w.ndim
    return np.transpose(w, (nd - 1, nd - 2, *range(nd - 2)))


def _carrier(a, device, dtype) -> torch.Tensor:
    """``a`` rounded to ``dtype`` and held in fp32 (exact): the operand form
    the round-once convs take (`ops/convolution.py`); 4D / 5D in channels-
    last memory."""
    return _tensor(a, device, dtype).float()


_PLAIN_HEAD = contextvars.ContextVar("redtail_torch_plain_head",
                                     default=False)


@contextlib.contextmanager
def plain_volume_head():
    """The 3D models' cost volume and 3D stack under `plain_lowering()`
    inside the block, the towers as in any forward: disparity mode's
    forward (`parallel/sharding.py`), as the JAX package's builds
    the concat volume and runs `_volume_head` after `_encode_pair`."""
    token = _PLAIN_HEAD.set(True)
    try:
        yield
    finally:
        _PLAIN_HEAD.reset(token)


class _Weights(nn.Module):
    """A layer's weight and bias, what `params_to_numpy` reads.

    Serving: fp32 carriers of the net's dtype, made once at load (exact:
    every bf16 value is an fp32 value), the operands of every frame's
    round-once conv, frozen. Training (``trainable``): fp32 master
    parameters that require grad, which the convs round to the net's dtype
    on every call (`ops/convolution.py:_ConvSum`, `_add_bias`), as the JAX
    package's train step casts its params; the gradient comes back to the
    masters in fp32."""

    def __init__(self, w, b, device, dtype, trainable: bool = False):
        super().__init__()
        held = torch.float32 if trainable else dtype
        self.weight = nn.Parameter(_carrier(w, device, held),
                                   requires_grad=trainable)
        self.bias = nn.Parameter(_carrier(b, device, held),
                                 requires_grad=trainable)


class _Conv(_Weights):
    """TF-SAME conv layer, 2D or 3D: the HWIO / DHWIO kernel held as
    OIHW / OIDHW. A stride-1 layer of a frozen bf16 net's 3D encoder
    (``k3``) also holds it in the K-major bf16 form of the hand-written
    conv + ELU kernel (`kernels/conv3d_k3.py:kernel_weights`), made once at
    load, which `conv_elu` passes on."""

    def __init__(self, w, b, stride: int, device, dtype,
                 trainable: bool = False, k3: bool = False):
        super().__init__(_torch_layout(w), b, device, dtype, trainable)
        self.stride = stride
        self.register_buffer(
            "kernel_kc", K3.kernel_weights(self.weight) if k3 else None,
            persistent=False)

    def forward(self, x):
        conv = conv3d_ncdhw if self.weight.dim() == 5 else conv2d_nchw
        return conv(x, self.weight, self.bias, self.stride)

    def conv_elu(self, x):
        """``elu(self(x))`` of a 3D layer, through the kernel where
        `ops.convolution.conv3d_k3_routes` holds."""
        return conv3d_elu_ncdhw(x, self.weight, self.bias, self.stride,
                                self.kernel_kc)


class _Int8Conv(nn.Module):
    """A 2D conv leaf {weights_q, w_scale, x_scale, biases} of
    `quant/stereo_int8.py`, as the JAX package's `_c2d` runs it: the input
    quantized with ``x_scale`` (`quantize_act`), int8 x int8 with an exact
    integer sum (`conv2d_int8`), dequantized by ``x_scale * w_scale`` (the
    product taken once, at load: the same fp32 multiply), the bias added in
    fp32 and one cast to the input's dtype. Inside `sharded_axis` it runs
    on this rank's rows, as `ops/convolution.py`'s convs do."""

    def __init__(self, leaf, stride: int, device, dtype):
        super().__init__()
        self.stride = stride
        w_q = np.asarray(leaf["weights_q"])
        if w_q.dtype != np.int8 or w_q.ndim != 4 or "x_scale" not in leaf:
            raise ValueError(
                "an int8 leaf holds 2D int8 'weights_q', 'w_scale' and "
                "'x_scale' (quantize_stereo_params_int8); dequantize a w8 "
                "tree first (dequantize_tree)")
        self.register_buffer("weight_q", torch.from_numpy(
            np.ascontiguousarray(np.transpose(w_q, (3, 2, 0, 1))))
            .to(device))
        x_scale = torch.tensor([np.float32(leaf["x_scale"])], device=device)
        w_scale = torch.from_numpy(np.asarray(leaf["w_scale"], np.float32)
                                   .reshape(-1)).to(device)
        self.register_buffer("x_scale", x_scale)
        self.register_buffer("w_scale", w_scale)
        self.register_buffer("scale", x_scale * w_scale)
        self.bias = nn.Parameter(_carrier(leaf["biases"], device, dtype),
                                 requires_grad=False)

    def forward(self, x):
        # sharded: the float rows exchanged, then quantized (elementwise,
        # so exact), the conv run on the slab without a pad on H
        strides = (self.stride, self.stride)
        k = self.weight_q.shape[2:]
        x, pads, own = sharded_conv_input(x, k, strides)
        if own is not None and own[1] == own[2]:
            return empty_conv_shard(x, self.weight_q.shape[0], k, strides,
                                    pads, own[0], x.dtype)
        acc = conv2d_int8_acc(quantize_act(x, self.x_scale), self.weight_q,
                              stride=strides, padding=pads)
        return dequantize_acc(acc, self.scale, self.bias, x.dtype)


class _FusedConv3D1(_Conv):
    """conv3D_1 over the concat cost volume. ``forward`` is the dense
    conv3d (the plain lowering); ``fused`` computes the same layer from the
    two feature maps (`ops/fused_cost_volume_conv.py`) with the
    `split_kernels` pair, derived at load and held as OIHW fp32 carriers
    (their only use is the round-once conv)."""

    def __init__(self, w, b, device, dtype):
        super().__init__(w, b, 1, device, dtype)
        for name, k in zip(("k_left", "k_right"),
                           split_kernels(torch.from_numpy(
                               np.asarray(w, np.float32)))):
            self.register_buffer(
                name, _carrier(_torch_layout(k.numpy()), device, dtype),
                persistent=False)

    def fused(self, left, right, max_disp: int):
        """(N, C, H, W) maps -> ELU'd output as an (N, K, D, H, W) view of
        (N, D, H, W, K) memory (`torch.channels_last_3d`)."""
        out = cost_volume_conv3d_nchw(left, right, self.k_left,
                                      self.k_right, self.bias,
                                      max_disp, apply_elu=True)
        return out.permute(0, 4, 1, 2, 3)

    def fused_packed(self, left, right, max_disp: int):
        """(N, C, H, W) maps -> the ELU'd output in the packed head's
        dh-shifted layout, (N, (D + 1) // 2 + 1, (H + 1) // 2 + 1, W, 4K)
        contiguous."""
        return cost_volume_conv3d_nchw(left, right, self.k_left, self.k_right,
                                       self.bias, max_disp,
                                       apply_elu=True, emit="dh_shifted")


class _ConvTranspose(_Weights):
    """TF conv{2,3}d_transpose layer, stride 2: the HWIO / DHWIO kernel
    (I = output channels) held as PyTorch's (in, out, *k). A 3D decoder
    layer of a frozen bf16 net (``s2``) also holds it in the form of the
    hand-written transposed conv kernel
    (`kernels/deconv3d_s2.py:kernel_weights`), made once at load, which
    `forward` and `deconv_elu` pass on."""

    def __init__(self, w, b, device, dtype, trainable: bool = False,
                 s2: bool = False):
        super().__init__(_torch_layout(w), b, device, dtype, trainable)
        self.register_buffer(
            "kernel_s2", D2.kernel_weights(self.weight) if s2 else None,
            persistent=False)

    def forward(self, x, out_spatial):
        if self.weight.dim() == 5:
            return deconv3d_s2_ncdhw(x, self.weight, self.bias,
                                     out_spatial=out_spatial,
                                     kernel_s2=self.kernel_s2)
        return conv2d_transpose_nchw(x, self.weight, self.bias,
                                     out_spatial=out_spatial, stride=2)

    def deconv_elu(self, x, out_spatial, skip):
        """``elu(self(x, out_spatial) + skip)`` of a 3D decoder layer,
        through the kernel where `ops.convolution.deconv3d_s2_routes`
        holds."""
        return deconv3d_s2_ncdhw(x, self.weight, self.bias, skip,
                                 out_spatial=out_spatial,
                                 kernel_s2=self.kernel_s2)


# --------------------------------------------------------- the packed head


@dataclass(frozen=True)
class _Step:
    """One layer of the packed head. ``op``: 'conv' (packed stride 1),
    'down', 'down_unpack', 'deconv', 'native' (an unpacked `_Conv`) or
    'final' (the c_out = 1 full-resolution deconv); ``d``: the original
    depth its kernel depends on (its input's for downsamples and 'final',
    its output's for 'deconv')."""

    name: str
    op: str
    packed_h: bool = False
    in_shifted: bool = False
    in_packed_d: bool = False
    skip: Optional[str] = None
    layout: str = "none"   # the layout of the step's output ('final': input)
    d: int = 0


def _packed_plan(spec: StereoSpec) -> Tuple[_Step, ...]:
    """The packed head's layer policy (JAX `_volume_head_packed`,
    `redtail_tpu/models/stereo.py:459-540`), walked from the spec once:
    conv3D_1's emission is DH-packed and shifted; stride-1 layers keep
    their input layout and flip the pair convention; downsamples move
    DH -> D and drop to unpacked once 2 * c_out > 128; decoders emit each
    skip's layout; the final deconv reads the packed layout."""
    layout, shift, d = "dh", True, spec.max_disp
    steps, skips = [], {}
    for layer in spec.enc3d[1:]:
        if layer.stride == 1:
            if layout == "none":
                steps.append(_Step(layer.name, "native"))
            else:
                steps.append(_Step(layer.name, "conv",
                                   packed_h=layout == "dh", in_shifted=shift,
                                   layout=layout))
                shift = not shift
        else:
            if shift:
                raise ValueError(f"{layer.name}: a downsample needs an "
                                 "aligned input")
            if layout == "dh" or (layout == "d" and 2 * layer.out_ch <= 128):
                steps.append(_Step(layer.name, "down",
                                   packed_h=layout == "dh", layout="d", d=d))
                layout = "d"
            elif layout == "d":
                steps.append(_Step(layer.name, "down_unpack", d=d))
                layout = "none"
            else:
                steps.append(_Step(layer.name, "native"))
            d = -(-d // 2)
        skips[layer.name] = (layout, shift, d)
    for name, _out_ch, skip in spec.dec3d:
        if skip is None:
            steps.append(_Step(name, "final", layout=layout, d=d))
            continue
        sk_layout, sk_shift, sk_d = skips[skip]
        if sk_shift or layout not in ("none", "d"):
            raise ValueError(f"{name}: skip {skip} must be aligned and the "
                             f"input unpacked or D-packed, not {layout}")
        steps.append(_Step(name, "deconv", in_packed_d=layout == "d",
                           packed_h=sk_layout == "dh", skip=skip,
                           layout=sk_layout, d=sk_d))
        layout, shift, d = sk_layout, sk_shift, sk_d
    return tuple(steps)


class _PackedConv3d(nn.Module):
    """One packed layer ('conv', 'down', 'down_unpack' or 'deconv' of
    `ops/packed3d.py`): its band-composed kernel for each row parity the
    kernel depends on, derived at load from the DHWIO weights and held in
    the conv's weight layout as a non-persistent buffer, with its bias: the
    cuDNN forms as fp32 carriers of the net's dtype (the round-once conv's
    operands), conv223's K-major form in the net's dtype (the CUDA kernel
    reads bf16 weights and sums in fp32 itself)."""

    def __init__(self, step: _Step, w, b, device, dtype):
        super().__init__()
        self.step = step
        wt = torch.from_numpy(np.asarray(w, np.float32))
        self.register_buffer("bias", _carrier(b, device, dtype),
                             persistent=False)
        # a downsample's H-packed band and a deconv's H-packed output band
        # depend on the row count's parity (the TF-SAME low pad)
        self.h_parity = step.packed_h and step.op in ("down", "deconv")
        for hp in ((0, 1) if self.h_parity else (0,)):
            spatial = (step.d, 2 + hp, 2)
            if step.op == "conv":
                k = P.prepare(P.conv3d_packed_kernel(
                    wt, packed_h=step.packed_h),
                    "conv223" if step.packed_h and step.in_shifted
                    else "conv")
            elif step.op == "down":
                k = P.prepare(P.conv3d_packed_down_kernel(
                    wt, full_spatial=spatial, packed_h=step.packed_h), "conv")
            elif step.op == "down_unpack":
                k = P.prepare(P.conv3d_packed_down_unpack_kernel(
                    wt, full_spatial=spatial), "conv")
            else:
                k = P.prepare(P.deconv3d_packed_kernel(
                    wt, out_spatial=spatial, in_packed_d=step.in_packed_d,
                    pack_h=step.packed_h), "lhs_dilated")
            k = k.to(device=device, dtype=dtype)
            if not (step.op == "conv" and step.packed_h and step.in_shifted):
                k = k.float()  # not conv223's: a carrier (band entries
                #                are weights or zeros, so exact)
            self.register_buffer(f"kernel{hp}", k, persistent=False)

    def forward(self, x, spatial):
        """``x``: NDHWC packed; ``spatial``: the original (D, H, W) of the
        input, or for 'deconv' of the output. The pad-slot masks take the
        layer's form (`_mask_scope`)."""
        with _mask_scope(self.step.name):
            return self._forward(x, spatial)

    def _forward(self, x, spatial):
        s = self.step
        k = getattr(self, f"kernel{spatial[1] % 2 if self.h_parity else 0}")
        if s.op == "conv":
            return P.conv3d_packed(x, None, self.bias, full_spatial=spatial,
                                   packed_h=s.packed_h,
                                   in_shifted=s.in_shifted, kernel=k)
        if s.op == "down":
            return P.conv3d_packed_down(x, None, self.bias,
                                        full_spatial=spatial,
                                        packed_h=s.packed_h, kernel=k)
        if s.op == "down_unpack":
            return P.conv3d_packed_down_unpack(x, None, self.bias,
                                               full_spatial=spatial, kernel=k)
        return P.deconv3d_packed(x, None, self.bias, out_spatial=spatial,
                                 in_packed_d=s.in_packed_d,
                                 pack_h=s.packed_h, kernel=k)


def _mask_scope(name: str):
    """The mask form of the packed layer ``name``, as the JAX package reads
    it per layer: ``REDTAIL_TPU_MASK_FORM`` (one form for every layer), else
    ``'mul'`` where ``REDTAIL_TPU_MASK_MUL`` (a comma list of layer names)
    names it, else the form in force (`ops.packed3d.mask_form`; ``'auto'``
    unless a caller set one)."""
    form = os.environ.get("REDTAIL_TPU_MASK_FORM") or (
        "mul" if name in os.environ.get("REDTAIL_TPU_MASK_MUL", "").split(",")
        else None)
    return P.mask_form(form) if form else contextlib.nullcontext()


class _DfoldDeconv3d(nn.Module):
    """The packed head's final c_out = 1 deconv as
    `conv3d_transpose_dfold` on the packed layout, disparity last, with the
    soft-argmin fused: (N, H, W) disparity. Its banded conv2d weights, for
    each parity of the output's (H, W), are derived at load and held, with
    the bias, as fp32 carriers of the net's dtype."""

    def __init__(self, step: _Step, w, b, *, d_out: int, device, dtype):
        super().__init__()
        self.h_packed = step.layout == "dh"
        wt = torch.from_numpy(np.asarray(w, np.float32))
        self.register_buffer("bias", _carrier(b, device, dtype),
                             persistent=False)
        d_in = 2 * (-(-step.d // 2))   # the packed slots' true depths
        self._blocks = {}
        for hp in (0, 1):
            for wp in (0, 1):
                meta = []
                for j, (i_lo, i_hi, ob, ob_hi, weight) in enumerate(
                        dfold_weights(wt, out_spatial=(d_out, 2 + hp, 2 + wp),
                                      d_in=d_in, h_packed=self.h_packed)):
                    name = f"weight{hp}{wp}_{j}"
                    self.register_buffer(name, weight.to(
                        device=device, dtype=dtype).float(),
                        persistent=False)
                    meta.append((i_lo, i_hi, ob, ob_hi, name))
                self._blocks[(hp, wp)] = meta

    def forward(self, x, out_spatial):
        blocks = [(i_lo, i_hi, ob, ob_hi, getattr(self, name))
                  for i_lo, i_hi, ob, ob_hi, name
                  in self._blocks[(out_spatial[1] % 2, out_spatial[2] % 2)]]
        return conv3d_transpose_dfold(
            x, None, self.bias, out_spatial=out_spatial, d_packed=True,
            h_packed=self.h_packed, layout="dlast", blocks=blocks,
            reduce=lambda t: softargmin(t[..., 0], axis=-1))


def _use_dfold(x: torch.Tensor) -> bool:
    """The packed head's final deconv as dfold: on the card, as the JAX
    package's accelerator does; elsewhere only with
    ``REDTAIL_TPU_DFOLD=1`` (its off-accelerator branch otherwise)."""
    return x.is_cuda or os.environ.get("REDTAIL_TPU_DFOLD") == "1"


class StereoNet(nn.Module):
    """One stereo network: NHWC image pair (values in [0, 1]) -> (N, H, W)
    disparity, in pixels for the 3D models and normalized to [0, 1] for
    ``resnet18_2d``.

    Submodules follow the JAX param paths (`encoder2D.resblock1.res_conv1`,
    `encoder3D.conv3D_1`, `decoder3D.deconv3D_1`, ...); `conv1_s2d` is the
    stem's exact 3x3 stride-1 form for space-to-depth packed input at
    ``spec.input_hw``.

    ``trainable``: the layers hold fp32 master parameters that require grad
    and cast them to ``dtype`` on every call (`_Weights`). Such a net runs
    the plain lowering only (the explicit concat volume and dense conv3D_1,
    as the JAX package trains): no fused conv3D_1, packed head or s2d stem,
    whose kernels would be derived once from weights that training moves;
    no int8 leaves."""

    def __init__(self, spec: StereoSpec, params: Params, *,
                 device: torch.device, dtype: torch.dtype,
                 trainable: bool = False):
        super().__init__()
        self.spec = spec
        self._dtype = dtype
        self.trainable = trainable
        strides = {f"bneck_encoder2D/{name}": s
                   for name, _, s in spec.bneck_channels}
        strides["encoder2D/conv1"] = 2
        strides.update({f"encoder3D/{layer.name}": layer.stride
                        for layer in spec.enc3d})
        fused = {f"encoder3D/{spec.enc3d[0].name}"} if spec.enc3d else set()
        # the encoder loop's stride-1 layers of a frozen bf16 net: their
        # form for the conv + ELU kernel, made at load
        k3 = set() if trainable or dtype != torch.bfloat16 else {
            f"encoder3D/{layer.name}" for layer in spec.enc3d[1:]
            if layer.stride == 1}
        for path, kshape, _ in _spec_layer_shapes(spec):
            leaf = params
            for p in path.split("/"):
                leaf = leaf[p]
            if "weights_q" in leaf:
                if trainable:
                    raise ValueError(f"{path}: an int8 leaf is a serving "
                                     "rung, not trainable")
                if path.startswith(("bneck_decoder2D/", "decoder3D/",
                                    "encoder3D/")):
                    raise ValueError(f"{path}: only 2D convs take int8 "
                                     "leaves")
                layer = _Int8Conv(leaf, strides.get(path, 1), device, dtype)
                if tuple(layer.weight_q.shape) != tuple(
                        kshape[i] for i in (3, 2, 0, 1)):
                    raise ValueError(f"{path}: int8 kernel shape "
                                     f"{np.shape(leaf['weights_q'])}, spec "
                                     f"wants {kshape}")
                self._add(path, layer)
                continue
            w, b = leaf["weights"], leaf["biases"]
            if tuple(w.shape) != kshape:
                raise ValueError(f"{path}: kernel shape {tuple(w.shape)}, "
                                 f"spec wants {kshape}")
            if path.startswith(("bneck_decoder2D/", "decoder3D/")):
                # a frozen bf16 net's 3D decoder layers: their form for the
                # transposed conv kernel, made at load
                layer = _ConvTranspose(
                    w, b, device, dtype, trainable,
                    s2=path.startswith("decoder3D/") and not trainable
                    and dtype == torch.bfloat16)
            elif path in fused and strides[path] == 1 and not trainable:
                layer = _FusedConv3D1(w, b, device, dtype)
            else:
                layer = _Conv(w, b, strides.get(path, 1), device, dtype,
                              trainable, k3=path in k3)
            self._add(path, layer)
        self._steps = ()
        if spec.enc3d and spec.enc3d[0].stride == 1 and not trainable:
            self._steps = _packed_plan(spec)
            self.packed3D = nn.ModuleDict()
            for step in self._steps:
                if step.op == "native":
                    continue
                leaf = params["decoder3D" if step.op in ("deconv", "final")
                              else "encoder3D"][step.name]
                if step.op != "final":
                    layer = _PackedConv3d(step, leaf["weights"],
                                          leaf["biases"], device, dtype)
                elif step.layout in ("d", "dh") \
                        and leaf["weights"].shape[3] == 1:
                    layer = _DfoldDeconv3d(step, leaf["weights"],
                                           leaf["biases"],
                                           d_out=spec.full_max_disp,
                                           device=device, dtype=dtype)
                else:
                    continue
                self.packed3D[step.name] = layer
        stem = params["encoder2D"]["conv1"]
        # an int8 stem takes only raw frames (no int8 s2d form), as in JAX
        self.conv1_s2d = None if "weights_q" in stem or trainable else _Conv(
            conv5s2_kernel_to_s2d(np.asarray(stem["weights"], np.float32),
                                  spec.input_hw),
            stem["biases"], 1, device, dtype)

    def _add(self, path: str, layer: nn.Module) -> None:
        *scopes, name = path.split("/")
        node = self
        for s in scopes:
            if not hasattr(node, s):
                node.add_module(s, nn.ModuleDict())
            node = getattr(node, s)
        node.add_module(name, layer)

    @property
    def dtype(self) -> torch.dtype:
        """The activations' dtype (the float weights', as built)."""
        return self._dtype

    @property
    def device(self) -> torch.device:
        return self.encoder2D.conv1.bias.device

    def _conv1(self, x):
        """The 5x5 stride-2 stem, or its 3x3 stride-1 form when ``x``
        arrives space-to-depth packed (12 channels)."""
        if x.shape[1] == 12:
            if self.conv1_s2d is None:
                raise ValueError("s2d-packed input unsupported with int8 "
                                 "conv1 or trainable weights: feed raw "
                                 "(N, H, W, 3) frames")
            return elu(self.conv1_s2d(x))
        return elu(self.encoder2D.conv1(x))

    def _towers_conv1(self, left, right):
        """Both towers' stem as one batch of 2N: the NHWC pair in the
        net's dtype, NCHW (`torch.channels_last`)."""
        return self._conv1(torch.cat([left, right]).to(self.dtype)
                           .permute(0, 3, 1, 2))

    def _plain_encoder(self, x, run):
        """NVTiny/NVSmall towers: conv2..4 + conv5 (no activation on
        conv5) after the stem."""
        enc = self.encoder2D
        for name in ("conv2", "conv3", "conv4"):
            x = run(f"towers_{name}", lambda a, c=enc[name]: elu(c(a)), x)
        return run("towers_conv5", enc.conv5, x)

    def _resnet_encoder(self, x, run):
        """8 residual blocks + encoder2D_out (no final act) after the
        stem."""
        enc = self.encoder2D
        for i in range(1, 9):
            x = run(f"towers_resblock{i}", lambda a, blk=enc[f"resblock{i}"]:
                    elu(blk.res_conv2(elu(blk.res_conv1(a))) + a), x)
        return run("towers_encoder2D_out", enc.encoder2D_out, x)

    def _bneck_head(self, d, conv1_act, full_hw, run):
        """Feature concat + 2D bottleneck encoder/decoder + sigmoid over the
        soft-argmax map ``d`` (N, H', W'), ``conv1_act`` both towers' stem
        output (the left tower's first N) -> (N, H, W) in [0, 1]."""
        n = d.shape[0]
        x = run("concat_conv1", lambda c, dd: torch.cat(
            [c[:n], dd.to(c.dtype).unsqueeze(1)], dim=1), conv1_act, d)
        extent = _half(full_hw)
        acts = {}
        for name, _out_ch, stride in self.spec.bneck_channels:
            with sharded_extent(extent):
                x = run(name, lambda a, c=self.bneck_encoder2D[name]:
                        elu(c(a)), x)
            extent = _global_spatial(x, _strided(extent, stride))
            acts[name] = (x, extent)
        for name, _out_ch, skip in self.spec.bneck_dec:
            layer = self.bneck_decoder2D[name]
            with sharded_extent(extent):
                if skip is not None:
                    sk, extent = acts[skip]
                    x = run(name, lambda a, s_, c=layer, o=extent: elu(
                        c(a, o) + s_), x, sk)
                else:
                    x = run(name, lambda a, c=layer: c(a, full_hw), x)
        return run("sigmoid", lambda a: sigmoid(a)[:, 0], x)

    def _volume_head(self, feats, sides, full_hw, run):
        """Cost volume + conv3D_1 (fused, or explicit under
        `plain_lowering()`), the 3D encoder/decoder and the soft-argmin:
        both towers' features (``sides``: the left and right (N, C, H', W')
        of them) -> (N, H, W) disparity in pixels."""
        spec = self.spec
        enc, first = self.encoder3D, spec.enc3d[0]
        fl, fr = sides
        if self._steps and use_packed3d():
            return self._volume_head_packed(feats, sides, full_hw, run)
        extent = (spec.max_disp, *_half(full_hw))
        if isinstance(enc[first.name], _FusedConv3D1) \
                and not use_plain_lowering():
            with sharded_extent(extent):
                x = run(f"cost_volume+{first.name}", lambda f: enc[
                    first.name].fused(fl(f), fr(f), spec.max_disp), feats)
        else:
            d_lo, d_hi = _disparity_block(spec.max_disp)
            vol = run("cost_volume", lambda f: cost_volume(
                fl(f).permute(0, 2, 3, 1).contiguous(),
                fr(f).permute(0, 2, 3, 1).contiguous(), spec.max_disp,
                d_offset=d_lo, d_count=d_hi - d_lo), feats)
            with sharded_extent(extent):
                x = run(first.name, lambda v: elu(
                    enc[first.name](v.permute(0, 4, 1, 2, 3))), vol)
        extent = _global_spatial(x, _strided(extent, first.stride))
        acts = {first.name: (x, extent)}
        for layer in spec.enc3d[1:]:
            with sharded_extent(extent):
                x = run(layer.name,
                        lambda a, c=enc[layer.name]: c.conv_elu(a), x)
            extent = _global_spatial(x, _strided(extent, layer.stride))
            acts[layer.name] = (x, extent)
        for name, _out_ch, skip in spec.dec3d:
            layer = self.decoder3D[name]
            with sharded_extent(extent):
                if skip is not None:
                    sk, extent = acts[skip]
                    x = run(name, lambda a, s_, c=layer, o=extent:
                            c.deconv_elu(a, o, s_), x, sk)
                else:
                    extent = (spec.full_max_disp, *full_hw)
                    x = run(name, lambda a, c=layer, o=extent: c(a, o), x)
        with sharded_extent(extent):
            return run("softargmin", lambda a: softargmin(a[:, 0], axis=1),
                       x)

    def _volume_head_packed(self, feats, sides, full_hw, run):
        """The packed head (`_packed_plan`): the emission kernel's
        dh-shifted conv3D_1 output through the packed 3D stack to the
        final deconv: dfold + fused soft-argmin on the card (or with
        ``REDTAIL_TPU_DFOLD=1``), else unpack + transposed conv +
        soft-argmin, the JAX package's off-accelerator branch. NDHWC
        activations throughout; (N, H, W) disparity in pixels."""
        spec = self.spec
        fl, fr = sides
        first = self.encoder3D[spec.enc3d[0].name]
        # every layer takes the global extent: a kernel's band, a pad and a
        # slot count follow the image's parities, not a shard's
        spatial = (spec.max_disp, *_half(full_hw))
        with sharded_extent(spatial):
            x = run(f"cost_volume+{spec.enc3d[0].name}[pk]", lambda f:
                    first.fused_packed(fl(f), fr(f), spec.max_disp), feats)
        acts = {}
        for step in self._steps:
            if step.op == "final":
                target = (spec.full_max_disp, *full_hw)
                if step.name in self.packed3D and _use_dfold(x):
                    return run(f"{step.name}+softargmin[pk]", lambda a, c=(
                        self.packed3D[step.name]): c(a, target), x)
                with sharded_extent(spatial):
                    if step.layout != "none":
                        x = run("unpack[pk]", lambda a, sp=spatial, ph=(
                            step.layout == "dh"): P.unpack_conv(
                                a, sp, packed_h=ph), x)
                    x = run(step.name, lambda a, c=self.decoder3D[step.name]:
                            c(a.permute(0, 4, 1, 2, 3), target), x)
                with sharded_extent(target):
                    return run("softargmin",
                               lambda a: softargmin(a[:, 0], axis=1), x)
            if step.op == "deconv":
                # its output slots are owned as its skip's are
                sk, spatial = acts[step.skip]
                x = run(f"{step.name}[pk]", lambda a, s_, c=(
                    self.packed3D[step.name]), sp=spatial: elu(
                        c(a, sp) + s_), x, sk)
                continue
            with sharded_extent(spatial):
                if step.op == "native":
                    x = run(step.name, lambda a, c=self.encoder3D[step.name]:
                            elu(c(a.permute(0, 4, 1, 2, 3))).permute(
                                0, 2, 3, 4, 1), x)
                else:
                    x = run(f"{step.name}[pk]", lambda a, c=(
                        self.packed3D[step.name]), sp=spatial: elu(c(a, sp)),
                        x)
            if step.op != "conv" and self.encoder3D[step.name].stride == 2:
                spatial = tuple(-(-v // 2) for v in spatial)
            acts[step.name] = (x, spatial)
        raise ValueError(f"{spec.name}: the packed plan has no final layer")

    def forward(self, left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
        """``left``/``right``: (N, H, W, 3) RGB in [0, 1], or s2d-packed
        (N, ceil(H/2), ceil(W/2), 12) with (H, W) = ``spec.input_hw``."""
        if not tracing():
            return self.layers(left, right, _call)
        with _StageSpans(self.spec) as run:
            return self.layers(left, right, run)

    def layers(self, left: torch.Tensor, right: torch.Tensor,
               run: Callable) -> torch.Tensor:
        """The forward, one layer at a time: each layer is computed as
        ``run(name, fn, *args)``, which must return ``fn(*args)``;
        `forward` passes a plain call, and
        `runtime/layer_profiler.stereo_layer_plan` one that records each
        (name, fn, args). Both towers run as one batch of 2N (entries
        ``towers_*``); the names follow the JAX package's layer plan
        (`redtail_tpu/runtime/layer_profiler.py`)."""
        spec = self.spec
        sh = current_sharding()
        if sh is not None:
            self._check_sharded(sh)
        # the frames' global rows: a shard's under image sharding
        rows = (sh.global_size if sh is not None and sh.axis == IMAGE_AXIS
                else left.shape[1])
        if left.shape[-1] == 12:
            full_hw = spec.input_hw
            in_hw = (rows, left.shape[2])
            if in_hw != s2d_hw(full_hw):
                raise ValueError(
                    f"s2d-packed input {tuple(left.shape)} does not match "
                    f"spec.input_hw {spec.input_hw} (expected spatial "
                    f"{s2d_hw(full_hw)})")
        else:
            full_hw = in_hw = (rows, left.shape[2])
        n = left.shape[0]
        with sharded_extent(in_hw):
            conv1_act = run("towers_conv1", self._towers_conv1, left, right)
        with sharded_extent(_half(full_hw)):
            if spec.encoder2d == "plain":
                feats = self._plain_encoder(conv1_act, run)
            else:
                feats = self._resnet_encoder(conv1_act, run)
        sides = (lambda t: t[:n], lambda t: t[n:])
        if not spec.corr:
            with (plain_lowering() if _PLAIN_HEAD.get()
                  else contextlib.nullcontext()):
                return self._volume_head(feats, sides, full_hw, run)
        # the correlation volume and its soft-argmax over D, one kernel,
        # on NHWC features (row-local: a shard's rows need no halo)
        fl, fr = sides
        d = run("corr_cost_volume+softargmax", lambda t: corr_softargmax_dlast(
            fl(t).permute(0, 2, 3, 1).contiguous(),
            fr(t).permute(0, 2, 3, 1).contiguous(), spec.max_disp), feats)
        return self._bneck_head(d, conv1_act, full_hw, run)

    def _check_sharded(self, sh) -> None:
        """Raise for a sharded forward this net cannot run."""
        if sh.axis == DISPARITY_AXIS and self.spec.corr:
            raise ValueError("disparity sharding applies to the 3D "
                             "cost-volume models")


def _half(hw) -> Tuple[int, int]:
    """The stem's output extent: (ceil(H / 2), ceil(W / 2))."""
    return tuple(-(-v // 2) for v in hw)


def _strided(extent, stride: int) -> Tuple[int, ...]:
    """A TF-SAME conv's output extent at ``stride`` on every axis."""
    return tuple(-(-v // stride) for v in extent)


def _global_spatial(x: torch.Tensor, extent) -> Tuple[int, ...]:
    """An activation's global spatial extent: ``extent`` (as derived from
    the spec) inside a sharded forward, else its own shape."""
    return tuple(extent) if current_sharding() is not None \
        else tuple(x.shape[2:])


def _disparity_block(max_disp: int) -> Tuple[int, int]:
    """The disparities [lo, hi) of the volume this rank builds: its block
    under disparity sharding, else all of them."""
    sh = current_sharding()
    if sh is not None and sh.axis == DISPARITY_AXIS:
        return sh.owned(max_disp)
    return 0, max_disp


def _call(_name: str, fn: Callable, *args):
    return fn(*args)


def layer_stage(spec: StereoSpec, name: str) -> str:
    """The span of the forward's stage that the layer ``name`` of
    `StereoNet.layers` belongs to: ``stereo/towers`` (the 2D towers),
    ``stereo/volume`` (the cost volume and what
    is fused with it: the emission's conv3D_1, the corr soft-argmax),
    ``stereo/enc3d`` and ``stereo/dec3d`` (the 3D stack's layers, packed
    or not, the packed head's unpack before the last deconv in dec3d),
    ``stereo/head`` (the soft-argmin and what is fused with it, or the
    correlation model's bottleneck head)."""
    if name.startswith("towers_"):
        return "stereo/towers"
    if "cost_volume" in name:
        return "stereo/volume"
    if "softargmin" in name:
        return "stereo/head"
    base = name.removesuffix("[pk]")
    if any(base == layer.name for layer in spec.enc3d):
        return "stereo/enc3d"
    if base == "unpack" or any(base == n for n, _, _ in spec.dec3d):
        return "stereo/dec3d"
    return "stereo/head"


class _StageSpans:
    """A ``run`` for `StereoNet.layers` that runs each layer inside the
    span of its stage (`layer_stage`), one span a stage: entered at the
    stage's first layer, left at the next stage's first or at the
    forward's end (an exception's too, as the remat recompute's early stop
    raises)."""

    def __init__(self, spec: StereoSpec):
        self._spec = spec
        self._stack = contextlib.ExitStack()
        self._stage = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return self._stack.__exit__(*exc)

    def __call__(self, name: str, fn: Callable, *args):
        stage = layer_stage(self._spec, name)
        if stage != self._stage:
            self._stack.close()
            self._stack.enter_context(span(stage))
            self._stage = stage
        return fn(*args)


def params_from_numpy(spec: StereoSpec, params: Params, *, device=None,
                      dtype: torch.dtype = torch.float32,
                      trainable: bool = False) -> StereoNet:
    """Build the model from the JAX package's nested param dict of numpy
    arrays (HWIO). ``device=None`` is the card (see `resolve_device`);
    ``trainable``: fp32 master parameters (see `StereoNet`)."""
    return StereoNet(spec, params, device=resolve_device(device), dtype=dtype,
                     trainable=trainable)


def params_to_numpy(net: StereoNet, *, grads: bool = False) -> Params:
    """The inverse of `params_from_numpy`: the nested HWIO / DHWIO param
    dict as float32 numpy (an int8 layer as its int8 leaf). ``grads``: the
    masters' gradients of a trainable net in the same layout instead."""
    params: Params = {}
    for path, _, _ in _spec_layer_shapes(net.spec):
        layer = net.get_submodule(path.replace("/", "."))
        *scopes, name = path.split("/")
        node = params
        for s in scopes:
            node = node.setdefault(s, {})
        if isinstance(layer, _Int8Conv):
            node[name] = {
                "weights_q": layer.weight_q.permute(2, 3, 1, 0).cpu().numpy(),
                "w_scale": layer.w_scale.cpu().numpy(),
                "x_scale": np.float32(layer.x_scale.item()),
                "biases": layer.bias.float().cpu().numpy()}
            continue
        w, b = layer.weight, layer.bias
        if grads:
            w, b = w.grad, b.grad
        nd = w.dim()
        # copies: a CPU net's arrays would otherwise alias its parameters
        node[name] = {
            "weights": w.detach().permute(*range(2, nd), 1, 0)
            .float().cpu().numpy().copy(),
            "biases": b.detach().float().cpu().numpy().copy()}
    return params


def stereo_forward(spec: StereoSpec, params, left: torch.Tensor,
                   right: torch.Tensor) -> torch.Tensor:
    """Counterpart of the JAX `stereo_forward`: NHWC pair -> (N, H, W)
    disparity, in pixels for the 3D models and normalized to [0, 1] for
    ``resnet18_2d``. ``params`` is a `StereoNet` built for
    ``spec``, or a nested numpy param dict, built here on ``left``'s
    device in ``left``'s dtype."""
    if isinstance(params, StereoNet):
        if params.spec != spec:
            raise ValueError(f"params were built for {params.spec}, not {spec}")
        net = params
    else:
        net = StereoNet(spec, params, device=left.device, dtype=left.dtype)
    return net(left, right)
