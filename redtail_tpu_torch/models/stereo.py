"""The stereo model zoo in PyTorch (`redtail_tpu/models/stereo.py`).

All four `STEREO_SPECS` are here as data; the ResNet18-2D network is
ported: siamese ResNet-18 encoder -> correlation cost volume (D = max_disp,
fp32, the CUDA kernel on the card) -> fp32 soft-argmax -> concat with the
left conv1 features -> 2D bottleneck encoder/decoder -> sigmoid, disparity
normalized to [0, 1] (multiply by the image width for pixels).

`StereoNet` is the `nn.Module`; `stereo_forward(spec, params, left, right)`
is the JAX function's counterpart. Weights arrive as the JAX package's
nested param dict of numpy arrays (HWIO, keys as in `_spec_layer_shapes`)
and are moved to PyTorch's layouts once, at load (`params_from_numpy`),
including the space-to-depth form of the stem. Activations are NHWC at the
public functions and NCHW in `torch.channels_last` memory inside.

This is the JAX package's plain path (its CPU defaults): per-tower
encoders, no H-packing, no block-diagonal towers. The two towers run as
one batch-2 chain of convs, which is exact.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from redtail_tpu_torch import resolve_device
from redtail_tpu_torch.ops.activations import elu, sigmoid
from redtail_tpu_torch.ops.convolution import (
    conv2d_nchw,
    conv2d_transpose_nchw,
)
from redtail_tpu_torch.ops.cost_volume import corr_cost_volume_dlast
from redtail_tpu_torch.ops.softargmax import softargmax
from redtail_tpu_torch.ops.space_to_depth import conv5s2_kernel_to_s2d, s2d_hw
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


def _has_quantized(node) -> bool:
    if isinstance(node, dict):
        return "weights_q" in node or any(
            _has_quantized(v) for v in node.values() if isinstance(v, dict))
    return False


def _param(a, device, dtype) -> nn.Parameter:
    t = torch.from_numpy(np.asarray(a, np.float32)).to(device=device,
                                                         dtype=dtype)
    if t.dim() == 4:
        t = t.contiguous(memory_format=torch.channels_last)
    return nn.Parameter(t, requires_grad=False)


class _Conv(nn.Module):
    """TF-SAME conv layer: the HWIO kernel held as OIHW."""

    def __init__(self, w_hwio, b, stride: int, device, dtype):
        super().__init__()
        self.stride = stride
        self.weight = _param(np.transpose(w_hwio, (3, 2, 0, 1)), device, dtype)
        self.bias = _param(b, device, dtype)

    def forward(self, x):
        return conv2d_nchw(x, self.weight, self.bias, self.stride)


class _ConvTranspose(nn.Module):
    """TF conv2d_transpose layer, stride 2: the HWIO kernel (I = output
    channels) held as PyTorch's (in, out, kh, kw)."""

    def __init__(self, w_hwio, b, device, dtype):
        super().__init__()
        self.weight = _param(np.transpose(w_hwio, (3, 2, 0, 1)), device, dtype)
        self.bias = _param(b, device, dtype)

    def forward(self, x, out_spatial):
        return conv2d_transpose_nchw(x, self.weight, self.bias,
                                     out_spatial=out_spatial, stride=2)


class StereoNet(nn.Module):
    """ResNet18-2D: NHWC image pair (values in [0, 1]) -> (N, H, W)
    sigmoid-normalized disparity.

    Submodules follow the JAX param paths (`encoder2D.resblock1.res_conv1`,
    `bneck_encoder2D.conv2D_1`, ...); `conv1_s2d` is the stem's exact 3x3
    stride-1 form for space-to-depth packed input at ``spec.input_hw``."""

    def __init__(self, spec: StereoSpec, params: Params, *,
                 device: torch.device, dtype: torch.dtype):
        super().__init__()
        if not spec.corr:
            raise NotImplementedError(
                f"{spec.name}: the 3D concat-volume models are not ported "
                "yet (ROADMAP.md, module queue item 4)")
        if _has_quantized(params):
            raise NotImplementedError(
                "int8 'weights_q' leaves are not ported yet (ROADMAP.md, "
                "module queue item 7)")
        self.spec = spec
        strides = {f"bneck_encoder2D/{name}": s
                   for name, _, s in spec.bneck_channels}
        strides["encoder2D/conv1"] = 2
        for path, kshape, _ in _spec_layer_shapes(spec):
            leaf = params
            for p in path.split("/"):
                leaf = leaf[p]
            w, b = leaf["weights"], leaf["biases"]
            if tuple(w.shape) != kshape:
                raise ValueError(f"{path}: kernel shape {tuple(w.shape)}, "
                                 f"spec wants {kshape}")
            if path.startswith("bneck_decoder2D/"):
                layer = _ConvTranspose(w, b, device, dtype)
            else:
                layer = _Conv(w, b, strides.get(path, 1), device, dtype)
            self._add(path, layer)
        stem = params["encoder2D"]["conv1"]
        self.conv1_s2d = _Conv(
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
        return self.conv1_s2d.weight.dtype

    def _conv1(self, x):
        """The 5x5 stride-2 stem, or its 3x3 stride-1 form when ``x``
        arrives space-to-depth packed (12 channels)."""
        stem = self.conv1_s2d if x.shape[1] == 12 else self.encoder2D.conv1
        return elu(stem(x))

    def _resnet_encoder(self, x):
        """conv1 + 8 residual blocks + encoder2D_out (no final act);
        returns (features, conv1 activation)."""
        enc = self.encoder2D
        x = self._conv1(x)
        conv1_act = x
        for i in range(1, 9):
            blk = enc[f"resblock{i}"]
            y = elu(blk.res_conv1(x))
            x = elu(blk.res_conv2(y) + x)
        return enc.encoder2D_out(x), conv1_act

    def _bneck_head(self, d, conv1_act, full_hw):
        """Feature concat + 2D bottleneck over the soft-argmax map ``d``
        (N, H', W') -> (N, H, W) in [0, 1]."""
        x = torch.cat([conv1_act, d.to(conv1_act.dtype).unsqueeze(1)], dim=1)
        acts = {}
        for name, _out_ch, _stride in self.spec.bneck_channels:
            x = elu(self.bneck_encoder2D[name](x))
            acts[name] = x
        return self._bneck_decode(x, acts, full_hw)

    def _bneck_decode(self, x, acts, full_hw):
        for name, _out_ch, skip in self.spec.bneck_dec:
            target = acts[skip].shape[2:] if skip is not None else full_hw
            x = self.bneck_decoder2D[name](x, tuple(target))
            if skip is not None:
                x = elu(x + acts[skip])
        return sigmoid(x)[:, 0]

    def forward(self, left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
        """``left``/``right``: (N, H, W, 3) RGB in [0, 1], or s2d-packed
        (N, ceil(H/2), ceil(W/2), 12) with (H, W) = ``spec.input_hw``."""
        spec = self.spec
        if left.shape[-1] == 12:
            full_hw = spec.input_hw
            if tuple(left.shape[1:3]) != s2d_hw(full_hw):
                raise ValueError(
                    f"s2d-packed input {tuple(left.shape)} does not match "
                    f"spec.input_hw {spec.input_hw} (expected spatial "
                    f"{s2d_hw(full_hw)})")
        else:
            full_hw = tuple(left.shape[1:3])
        n = left.shape[0]
        x = torch.cat([left, right]).to(self.dtype).permute(0, 3, 1, 2)
        feats, conv1_act = self._resnet_encoder(x)
        feats = feats.permute(0, 2, 3, 1).contiguous()  # NHWC for the kernel
        vol = corr_cost_volume_dlast(feats[:n], feats[n:], spec.max_disp)
        d = softargmax(vol, axis=-1)
        return self._bneck_head(d, conv1_act[:n], full_hw)


def params_from_numpy(spec: StereoSpec, params: Params, *, device=None,
                      dtype: torch.dtype = torch.float32) -> StereoNet:
    """Build the model from the JAX package's nested param dict of numpy
    arrays (HWIO). ``device=None`` is the card (see `resolve_device`)."""
    return StereoNet(spec, params, device=resolve_device(device), dtype=dtype)


def params_to_numpy(net: StereoNet) -> Params:
    """The inverse of `params_from_numpy`: the nested HWIO param dict as
    float32 numpy."""
    params: Params = {}
    for path, _, _ in _spec_layer_shapes(net.spec):
        layer = net.get_submodule(path.replace("/", "."))
        *scopes, name = path.split("/")
        node = params
        for s in scopes:
            node = node.setdefault(s, {})
        node[name] = {
            "weights": layer.weight.permute(2, 3, 1, 0).float().cpu().numpy(),
            "biases": layer.bias.float().cpu().numpy()}
    return params


def stereo_forward(spec: StereoSpec, params, left: torch.Tensor,
                   right: torch.Tensor) -> torch.Tensor:
    """Counterpart of the JAX `stereo_forward`: NHWC pair -> (N, H, W)
    sigmoid-normalized disparity. ``params`` is a `StereoNet` built for
    ``spec``, or a nested numpy param dict, built here on ``left``'s
    device in ``left``'s dtype."""
    if isinstance(params, StereoNet):
        if params.spec != spec:
            raise ValueError(f"params were built for {params.spec}, not {spec}")
        net = params
    else:
        net = StereoNet(spec, params, device=left.device, dtype=left.dtype)
    return net(left, right)
