"""Plain PyTorch reference of NVIDIA-AI-IOT/redtail's stereoDNN nets: the
concat-volume 3D nets (NVSmall, NVTiny, ResNet-18 3D) and the correlation
net ResNet18-2D; their smooth-L1 loss and an Adam update.

Written from the published network descriptions alone, in float32 with
TF32 off: TF-SAME convolutions and transposed convolutions, ELU, the 2D
towers (plain, or ResNet-18's residual blocks), then one of two heads.

- The 3D head (``enc3d`` / ``dec3d``): the concat cost volume at half
  resolution, the 3D encoder / decoder with skip additions and the
  soft-argmin over the full-resolution disparity axis.
- The correlation head (``"corr": true``; `resnet18_2D_513x257_net.cpp`):
  the correlation of the two towers' maps at half resolution, ``c[d](y,
  x) = sum over channels of fl(y, x) fr(y, x - d)``, zero where x < d,
  for d < max_disp; its soft-argmax over D (the softmax of +c, then the
  expected index); that map joined after the left tower's conv1
  activation; the 2D bottleneck (``bneck_channels``: TF-SAME 3x3 convs
  with ELU; ``bneck_dec``: stride-2 transposed convs cropped as
  `deconv` crops, ELU(deconv + skip) where there is a skip, the last to
  (H, W) with no ELU); a sigmoid. Departures from the published net: the
  sigmoid is multiplied by the configuration's input width, so the output
  is in pixels as the 3D nets' is (the published net leaves it in [0, 1]
  and its sample app multiplies it out); the correlation and soft-argmax
  are written as one product-sum per disparity and a softmax in float32,
  where the published net runs a cost-volume plugin and a separate
  softmax layer.

The layer table comes from the configuration file (`configs/*.json`), the
weights from the nested HWIO / DHWIO numpy dict the benchmark made.

``precision="fp8"`` is the control: every conv's operands and output
rounded to float8 e4m3 with a per-tensor scale (the tensor's largest
magnitude mapped to e4m3's largest finite value), and the gradients
through those points to e5m2: the step below bf16 that a faster serving
or training path would take, at the points where the program rounds to
bf16. The correlation, its soft-argmax and the sigmoid run in float32 on
the rounded maps, as the program runs them.

Imports nothing of the measured program.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

PRECISIONS = ("fp32", "fp8")
E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def layer_table(config: dict) -> List[Tuple[str, tuple, tuple]]:
    """(path, kernel shape HWIO / DHWIO, bias shape) of every layer; a
    transposed conv's kernel is ([kd,] kh, kw, its output, its input)."""
    out = []
    ch = config["enc2d_channels"]
    if config["encoder2d"] == "plain":
        c_in = 3
        for i, c in enumerate(ch, start=1):
            k = 5 if i == 1 else 3
            out.append((f"encoder2D/conv{i}", (k, k, c_in, c), (c,)))
            c_in = c
        feat = ch[-1]
    else:
        f = ch[0]
        out.append(("encoder2D/conv1", (5, 5, 3, f), (f,)))
        for i in range(1, 9):
            for j in (1, 2):
                out.append((f"encoder2D/resblock{i}/res_conv{j}",
                            (3, 3, f, f), (f,)))
        out.append(("encoder2D/encoder2D_out", (3, 3, f, f), (f,)))
        feat = f
    c_in = 2 * feat
    for name, c_out, _stride in config["enc3d"]:
        out.append((f"encoder3D/{name}", (3, 3, 3, c_in, c_out), (c_out,)))
        c_in = c_out
    for name, c_out, _skip in config["dec3d"]:
        out.append((f"decoder3D/{name}", (3, 3, 3, c_out, c_in), (c_out,)))
        c_in = c_out
    if config.get("corr"):
        c_in = 1 + ch[0]  # the soft-argmax map and the left conv1 activation
        for name, c_out, _stride in config["bneck_channels"]:
            out.append((f"bneck_encoder2D/{name}", (3, 3, c_in, c_out),
                        (c_out,)))
            c_in = c_out
        for name, c_out, _skip in config["bneck_dec"]:
            out.append((f"bneck_decoder2D/{name}", (3, 3, c_out, c_in),
                        (c_out,)))
            c_in = c_out
    return out


def leaf(tree: dict, path: str):
    node = tree
    for part in path.split("/"):
        node = node[part]
    return node


def to_torch(tree: dict, config: dict, device) -> Dict[str, torch.Tensor]:
    """path/weights, path/biases -> fp32 tensors; kernels in PyTorch's
    (out, in, *k) layout, a transposed conv's as (in, out, *k)."""
    out = {}
    for path, kshape, _ in layer_table(config):
        node = leaf(tree, path)
        w = torch.as_tensor(np.asarray(node["weights"], np.float32))
        nd = w.dim()
        out[f"{path}/weights"] = w.permute(nd - 1, nd - 2,
                                           *range(nd - 2)).contiguous() \
            .to(device)
        out[f"{path}/biases"] = torch.as_tensor(
            np.asarray(node["biases"], np.float32)).to(device)
    return out


def _fp8(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """``x`` through ``dtype`` with a per-tensor scale that maps its
    largest magnitude to ``top``."""
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, top / amax, torch.ones_like(amax))
    return (x * scale).to(dtype).float() / scale


class _RoundFp8(torch.autograd.Function):
    """e4m3 forward; the gradient through it rounded to e5m2, as an fp8
    training step carries its cotangents and gradients (the program rounds
    the same points to bf16)."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2, E5M2_MAX)


def _round(x: torch.Tensor, precision: str) -> torch.Tensor:
    return x if precision == "fp32" else _RoundFp8.apply(x)


def same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """TensorFlow's SAME padding of one axis: output ceil(size / s)."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv(x, w, b, stride: int, precision: str):
    """TF-SAME conv (2D or 3D) of channels-first ``x``."""
    pads = [same_pads(n, k, stride) for n, k in zip(x.shape[2:], w.shape[2:])]
    x = F.pad(x, [p for pair in reversed(pads) for p in pair])
    fn = F.conv3d if x.dim() == 5 else F.conv2d
    y = fn(_round(x, precision), _round(w, precision), stride=stride)
    return _round(y + b.reshape(-1, *[1] * (y.dim() - 2)), precision)


def deconv(x, w, b, out_spatial: Sequence[int], precision: str):
    """TF SAME ``conv{2,3}d_transpose``, stride 2: the transposed conv
    cropped at the forward conv's low pad to ``out_spatial``."""
    fn = F.conv_transpose3d if x.dim() == 5 else F.conv_transpose2d
    y = fn(_round(x, precision), _round(w, precision), stride=2)
    crop = []
    for size, full, k in zip(out_spatial, y.shape[2:], w.shape[2:]):
        lo = same_pads(size, k, 2)[0]
        if lo + size > full:
            raise ValueError(f"{tuple(out_spatial)} is no SAME output of "
                             f"{tuple(x.shape[2:])}")
        crop.append(slice(lo, lo + size))
    y = y[(slice(None), slice(None), *crop)]
    return _round(y + b.reshape(-1, *[1] * (y.dim() - 2)), precision)


def cost_volume(fl: torch.Tensor, fr: torch.Tensor, d: int) -> torch.Tensor:
    """(N, C, H, W) x2 -> (N, 2C, D, H, W): slice i holds the left map and
    the right map shifted right by i (zero where x < i)."""
    n, c, h, w = fl.shape
    vol = fl.new_zeros((n, 2 * c, d, h, w))
    for i in range(d):
        vol[:, :c, i] = fl
        vol[:, c:, i, :, i:] = fr[..., :w - i]
    return vol


def correlation(fl: torch.Tensor, fr: torch.Tensor, d: int) -> torch.Tensor:
    """(N, C, H, W) x2 -> (N, D, H, W): slice i holds the sum over channels
    of the left map times the right map shifted right by i (zero where
    x < i)."""
    n, _c, h, w = fl.shape
    vol = fl.new_zeros((n, d, h, w))
    for i in range(min(d, w)):
        vol[:, i, :, i:] = (fl[..., i:] * fr[..., :w - i]).sum(1)
    return vol


def soft_argmax(vol: torch.Tensor) -> torch.Tensor:
    """(N, D, H, W) -> (N, H, W): the expected index under the softmax of
    the volume over D."""
    prob = torch.softmax(vol, dim=1)
    idx = torch.arange(vol.shape[1], dtype=prob.dtype, device=prob.device)
    return (prob * idx.reshape(1, -1, 1, 1)).sum(1)


def forward(p: Dict[str, torch.Tensor], config: dict, left: torch.Tensor,
            right: torch.Tensor, precision: str = "fp32") -> torch.Tensor:
    """NHWC RGB pair in [0, 1] -> (N, H, W) disparity in pixels."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}")
    with fp32_math():
        return _forward(p, config, left, right, precision)


def _forward(p, config, left, right, precision):
    n, h, w, _ = left.shape
    x = torch.cat([left, right]).permute(0, 3, 1, 2).float()

    def c2(x, path, stride=1):
        return conv(x, p[f"{path}/weights"], p[f"{path}/biases"], stride,
                    precision)

    x = stem = F.elu(c2(x, "encoder2D/conv1", 2))
    if config["encoder2d"] == "plain":
        for i in range(2, len(config["enc2d_channels"])):
            x = F.elu(c2(x, f"encoder2D/conv{i}"))
        x = c2(x, f"encoder2D/conv{len(config['enc2d_channels'])}")
    else:
        for i in range(1, 9):
            blk = f"encoder2D/resblock{i}"
            x = F.elu(c2(F.elu(c2(x, f"{blk}/res_conv1")),
                         f"{blk}/res_conv2") + x)
        x = c2(x, "encoder2D/encoder2D_out")
    d = config["max_disp"]
    if config.get("corr"):
        return _corr_head(p, c2, config, stem[:n], x[:n], x[n:], (h, w),
                          precision)
    x = cost_volume(x[:n], x[n:], d)
    acts = {}
    for name, _c, stride in config["enc3d"]:
        x = F.elu(c2(x, f"encoder3D/{name}", stride))
        acts[name] = x
    for name, _c, skip in config["dec3d"]:
        path = f"decoder3D/{name}"
        wt, b = p[f"{path}/weights"], p[f"{path}/biases"]
        if skip is None:
            x = deconv(x, wt, b, (2 * d, h, w), precision)
        else:
            s = acts[skip]
            x = F.elu(deconv(x, wt, b, s.shape[2:], precision) + s)
    return soft_argmax(-x[:, 0])


def _corr_head(p, c2, config, conv1_left, fl, fr, hw, precision):
    """The correlation head: the left conv1 activation and the towers'
    maps -> (N, H, W) disparity in pixels: the sigmoid times the width the
    configuration states (a training crop's too, as the net is trained to
    give a fraction of its deployed width)."""
    disp = soft_argmax(correlation(fl, fr, config["max_disp"]))
    x = torch.cat([conv1_left, disp[:, None]], dim=1)
    acts = {}
    for name, _c, stride in config["bneck_channels"]:
        x = F.elu(c2(x, f"bneck_encoder2D/{name}", stride))
        acts[name] = x
    for name, _c, skip in config["bneck_dec"]:
        path = f"bneck_decoder2D/{name}"
        wt, b = p[f"{path}/weights"], p[f"{path}/biases"]
        if skip is None:
            x = deconv(x, wt, b, hw, precision)
        else:
            s = acts[skip]
            x = F.elu(deconv(x, wt, b, s.shape[2:], precision) + s)
    return torch.sigmoid(x[:, 0]) * config["input_hw"][1]


def frames_to_rgb(x_u8: torch.Tensor) -> torch.Tensor:
    """uint8 BGR (N, H, W, 3) -> float32 RGB in [0, 1]."""
    return x_u8.flip(-1).float() / 255.0


def smooth_l1(pred, target, valid, delta: float = 1.0) -> torch.Tensor:
    """The masked mean of the Huber / smooth-L1 terms."""
    err = pred - target
    a = err.abs()
    terms = torch.where(a < delta, 0.5 * err * err / delta, a - 0.5 * delta)
    return (terms * valid).sum() / valid.sum().clamp(min=1.0)


@contextlib.contextmanager
def fp32_math():
    """cuDNN's and cuBLAS's TF32 off inside the block (restored after): the
    reference's convolutions and products in float32."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


class Trainer:
    """The network's weights as fp32 leaves and Adam (torch's and optax's
    defaults: betas 0.9, 0.999, eps 1e-8) written out, one step a call."""

    def __init__(self, config: dict, tree: dict, device, *, lr: float,
                 precision: str = "fp32", betas=(0.9, 0.999),
                 eps: float = 1e-8):
        self.config, self.precision = config, precision
        self.lr, self.betas, self.eps = lr, betas, eps
        self.p = to_torch(tree, config, device)
        for v in self.p.values():
            v.requires_grad_(True)
        self.m = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.s = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.t = 0
        self.first_norms = None

    def step(self, batch) -> torch.Tensor:
        """One Adam step on (left, right, target, valid); the loss."""
        left, right, target, valid = batch
        b1, b2 = self.betas
        with fp32_math():
            pred = forward(self.p, self.config, left, right, self.precision)
            loss = smooth_l1(pred, target, valid)
            grads = torch.autograd.grad(loss, list(self.p.values()))
        self.t += 1
        with torch.no_grad():
            if self.first_norms is None:
                self.first_norms = {
                    k: float(torch.linalg.vector_norm(g.double()))
                    for k, g in zip(self.p, grads)}
            for (k, v), g in zip(self.p.items(), grads):
                self.m[k].mul_(b1).add_(g, alpha=1 - b1)
                self.s[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                m_hat = self.m[k] / (1 - b1 ** self.t)
                s_hat = self.s[k] / (1 - b2 ** self.t)
                v.sub_(self.lr * m_hat / (s_hat.sqrt() + self.eps))
        return loss.detach()

    def leaves(self) -> Dict[str, torch.Tensor]:
        return self.p

    def first_grads(self) -> Dict[str, torch.Tensor]:
        """After the first step: the first moment over (1 - beta1)."""
        return {k: v / (1 - self.betas[0]) for k, v in self.m.items()}


def train(config: dict, tree: dict, batches, *, steps: int, device,
          lr: float, precision: str = "fp32") -> dict:
    """``steps`` Adam steps from ``tree`` on ``batches`` (left, right,
    target, valid on the device): each step's loss, each leaf's first
    gradient norm and each leaf's change norm after the last step."""
    trainer = Trainer(config, tree, device, lr=lr, precision=precision)
    start = {k: v.detach().clone() for k, v in trainer.p.items()}
    losses = [float(trainer.step(batches[t])) for t in range(steps)]
    change = {k: float(torch.linalg.vector_norm((v.detach() - start[k])
                                                .double()))
              for k, v in trainer.p.items()}
    return {"losses": losses, "grad_norms": trainer.first_norms,
            "change_norms": change}
