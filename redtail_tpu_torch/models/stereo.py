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
(`params_from_numpy`), including the space-to-depth form of the stem.
Activations are NHWC at the public functions and NCHW / NCDHW in
`torch.channels_last` / `torch.channels_last_3d` memory inside.

This is the JAX package's unpacked path (its CPU defaults): per-tower
encoders, no H-packing, no block-diagonal towers, no packed 3D layouts.
The two towers run as one batch-2 chain of convs, which is exact.
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
    conv3d_ncdhw,
    conv3d_transpose_ncdhw,
    use_plain_lowering,
)
from redtail_tpu_torch.ops.cost_volume import (
    corr_cost_volume_dlast,
    cost_volume,
)
from redtail_tpu_torch.ops.fused_cost_volume_conv import (
    cost_volume_conv3d_nchw,
    split_kernels,
)
from redtail_tpu_torch.ops.softargmax import softargmax, softargmin
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


def _has_quantized(node) -> bool:
    if isinstance(node, dict):
        return "weights_q" in node or any(
            _has_quantized(v) for v in node.values() if isinstance(v, dict))
    return False


def _tensor(a, device, dtype) -> torch.Tensor:
    t = torch.from_numpy(np.asarray(a, np.float32)).to(device=device,
                                                         dtype=dtype)
    if t.dim() == 4:
        return t.contiguous(memory_format=torch.channels_last)
    if t.dim() == 5:
        return t.contiguous(memory_format=torch.channels_last_3d)
    return t


def _param(a, device, dtype) -> nn.Parameter:
    return nn.Parameter(_tensor(a, device, dtype), requires_grad=False)


def _torch_layout(w: np.ndarray) -> np.ndarray:
    """HWIO / DHWIO -> PyTorch's (O, I, *k); for a transposed conv, whose
    I is its output, that is PyTorch's (in, out, *k)."""
    nd = w.ndim
    return np.transpose(w, (nd - 1, nd - 2, *range(nd - 2)))


class _Conv(nn.Module):
    """TF-SAME conv layer, 2D or 3D: the HWIO / DHWIO kernel held as
    OIHW / OIDHW."""

    def __init__(self, w, b, stride: int, device, dtype):
        super().__init__()
        self.stride = stride
        self.weight = _param(_torch_layout(w), device, dtype)
        self.bias = _param(b, device, dtype)

    def forward(self, x):
        conv = conv3d_ncdhw if self.weight.dim() == 5 else conv2d_nchw
        return conv(x, self.weight, self.bias, self.stride)


class _FusedConv3D1(_Conv):
    """conv3D_1 over the concat cost volume. ``forward`` is the dense
    conv3d (the plain lowering); ``fused`` computes the same layer from the
    two feature maps (`ops/fused_cost_volume_conv.py`) with the
    `split_kernels` pair, derived at load and held as OIHW buffers."""

    def __init__(self, w, b, device, dtype):
        super().__init__(w, b, 1, device, dtype)
        for name, k in zip(("k_left", "k_right"),
                           split_kernels(torch.from_numpy(
                               np.asarray(w, np.float32)))):
            self.register_buffer(
                name, _tensor(_torch_layout(k.numpy()), device, dtype),
                persistent=False)

    def fused(self, left, right, max_disp: int):
        """(N, C, H, W) maps -> ELU'd output as an (N, K, D, H, W) view of
        (N, D, H, W, K) memory (`torch.channels_last_3d`)."""
        out = cost_volume_conv3d_nchw(left, right, self.k_left,
                                      self.k_right, self.bias, max_disp,
                                      apply_elu=True)
        return out.permute(0, 4, 1, 2, 3)


class _ConvTranspose(nn.Module):
    """TF conv{2,3}d_transpose layer, stride 2: the HWIO / DHWIO kernel
    (I = output channels) held as PyTorch's (in, out, *k)."""

    def __init__(self, w, b, device, dtype):
        super().__init__()
        self.weight = _param(_torch_layout(w), device, dtype)
        self.bias = _param(b, device, dtype)

    def forward(self, x, out_spatial):
        conv = (conv3d_transpose_ncdhw if self.weight.dim() == 5
                else conv2d_transpose_nchw)
        return conv(x, self.weight, self.bias, out_spatial=out_spatial,
                    stride=2)


class StereoNet(nn.Module):
    """One stereo network: NHWC image pair (values in [0, 1]) -> (N, H, W)
    disparity, in pixels for the 3D models and normalized to [0, 1] for
    ``resnet18_2d``.

    Submodules follow the JAX param paths (`encoder2D.resblock1.res_conv1`,
    `encoder3D.conv3D_1`, `decoder3D.deconv3D_1`, ...); `conv1_s2d` is the
    stem's exact 3x3 stride-1 form for space-to-depth packed input at
    ``spec.input_hw``."""

    def __init__(self, spec: StereoSpec, params: Params, *,
                 device: torch.device, dtype: torch.dtype):
        super().__init__()
        if _has_quantized(params):
            raise NotImplementedError(
                "int8 'weights_q' leaves are not ported yet (ROADMAP.md, "
                "module queue item 7)")
        self.spec = spec
        strides = {f"bneck_encoder2D/{name}": s
                   for name, _, s in spec.bneck_channels}
        strides["encoder2D/conv1"] = 2
        strides.update({f"encoder3D/{layer.name}": layer.stride
                        for layer in spec.enc3d})
        fused = {f"encoder3D/{spec.enc3d[0].name}"} if spec.enc3d else set()
        for path, kshape, _ in _spec_layer_shapes(spec):
            leaf = params
            for p in path.split("/"):
                leaf = leaf[p]
            w, b = leaf["weights"], leaf["biases"]
            if tuple(w.shape) != kshape:
                raise ValueError(f"{path}: kernel shape {tuple(w.shape)}, "
                                 f"spec wants {kshape}")
            if path.startswith(("bneck_decoder2D/", "decoder3D/")):
                layer = _ConvTranspose(w, b, device, dtype)
            elif path in fused and strides[path] == 1:
                layer = _FusedConv3D1(w, b, device, dtype)
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

    def _plain_encoder(self, x):
        """NVTiny/NVSmall tower: conv1 5x5 s2 + conv2..4 + conv5 (no
        activation on conv5)."""
        enc = self.encoder2D
        x = self._conv1(x)
        for name in ("conv2", "conv3", "conv4"):
            x = elu(enc[name](x))
        return enc.conv5(x)

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

    def _volume_head(self, fl, fr, full_hw):
        """Cost volume + conv3D_1 (fused, or explicit under
        `plain_lowering()`), the 3D encoder/decoder and the soft-argmin:
        (N, C, H', W') feature maps -> (N, H, W) disparity in pixels."""
        spec = self.spec
        enc, first = self.encoder3D, spec.enc3d[0]
        if isinstance(enc[first.name], _FusedConv3D1) \
                and not use_plain_lowering():
            x = enc[first.name].fused(fl, fr, spec.max_disp)
        else:
            vol = cost_volume(fl.permute(0, 2, 3, 1).contiguous(),
                              fr.permute(0, 2, 3, 1).contiguous(),
                              spec.max_disp)
            x = elu(enc[first.name](vol.permute(0, 4, 1, 2, 3)))
        acts = {first.name: x}
        for layer in spec.enc3d[1:]:
            x = elu(enc[layer.name](x))
            acts[layer.name] = x
        for name, _out_ch, skip in spec.dec3d:
            target = (acts[skip].shape[2:] if skip is not None
                      else (spec.full_max_disp, *full_hw))
            x = self.decoder3D[name](x, tuple(target))
            if skip is not None:
                x = elu(x + acts[skip])
        return softargmin(x[:, 0], axis=1)

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
        if spec.encoder2d == "plain":
            feats = self._plain_encoder(x)
        else:
            feats, conv1_act = self._resnet_encoder(x)
        if not spec.corr:
            return self._volume_head(feats[:n], feats[n:], full_hw)
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
    """The inverse of `params_from_numpy`: the nested HWIO / DHWIO param
    dict as float32 numpy."""
    params: Params = {}
    for path, _, _ in _spec_layer_shapes(net.spec):
        layer = net.get_submodule(path.replace("/", "."))
        *scopes, name = path.split("/")
        node = params
        for s in scopes:
            node = node.setdefault(s, {})
        nd = layer.weight.dim()
        node[name] = {
            "weights": layer.weight.permute(*range(2, nd), 1, 0)
            .float().cpu().numpy(),
            "biases": layer.bias.float().cpu().numpy()}
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
