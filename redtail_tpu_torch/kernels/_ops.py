"""The six forward kernels as `torch.library` custom ops, so `torch.export`
can trace a model through them and an AOTInductor engine can call them.

| op | wrapper | kernel |
| --- | --- | --- |
| `redtail_torch::corr_cost_volume(left, right, max_disp, mode, groups, rows)` | `corr_cost_volume.corr_cost_volume`, `corr_softargmax` | `csrc/corr_cost_volume.cu` (``mode``: `hdw`, `dlast`, `softargmax`; ``groups`` > 1 and ``rows``: the grouped `softargmax`) |
| `redtail_torch::cost_volume_concat(left, right, max_disp, d_offset, d_count)` | `cost_volume_concat.cost_volume_concat` | `csrc/cost_volume_concat.cu` |
| `redtail_torch::fused_cv_emit(la, rb, bias, max_disp, elu, layout)` | `fused_cv_emit.fused_cv_emit` | `csrc/fused_cv_emit.cu` (``layout``: `full`, `dh_shifted`) |
| `redtail_torch::conv223(xp, k, bias, k_layout)` | `conv223.conv223` | `csrc/conv223.cu` |
| `redtail_torch::conv3d_k3(x, kt, bias)` | `conv3d_k3.conv3d_k3` | `csrc/conv3d_k3.cu` |
| `redtail_torch::deconv3d_s2(y, kt, bias, skip, out_spatial)` | `deconv3d_s2.deconv3d_s2` | `csrc/deconv3d_s2.cu` |

Each op has three implementations:

- on CUDA tensors, the kernel: the wrapper module's `_launch`, on the
  current stream, adding one to the wrapper's launch counter, so an
  engine's launches count in the process that runs it;
- on CPU tensors, the plain PyTorch version;
- a fake one (`register_fake`) that derives the output from the shapes
  alone, for tracing: no pointer, tile plan or SM count is read there.

Both real device keys take the wrapper module's `_forward`, which picks the
plain version or the kernel by the wrapper's own `_on_cpu` (so a test can
force the CUDA route on CPU tensors, `tests/test_torch_kernel_autograd.py`).
The public wrappers check their inputs (`_check`, `_on_cpu`) and then call
the op. Autograd is the wrappers' as before: the corr and concat volumes'
`torch.autograd.Function`s (`_Corr`, `_Concat`) call `_forward` themselves,
and a CPU call of the emission or conv223 that needs grad runs the plain
version itself; the ops carry no gradient.

Each op also has a flop formula for `torch.utils.flop_counter`, the
operation counts `chip_smoke.py` bounds each kernel with: the corr volume
2 C per valid (x, d) pair (any epilogue), the concat volume none (a copy),
the emission 4 per output of the full layout, conv223 2 x 12 C per output,
conv3d_k3 2 x 27 C per output (its ELU not counted), deconv3d_s2 2 x 27 C
c_out per input position (its skip add and ELU not counted).

This module imports only the kernel wrappers: a process that loads an
engine imports it (the package's `kernels/__init__.py` does) and nothing
of the models.
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from redtail_tpu_torch.kernels import conv223 as _c223
from redtail_tpu_torch.kernels import conv3d_k3 as _k3
from redtail_tpu_torch.kernels import corr_cost_volume as _corr
from redtail_tpu_torch.kernels import cost_volume_concat as _concat
from redtail_tpu_torch.kernels import deconv3d_s2 as _d2
from redtail_tpu_torch.kernels import fused_cv_emit as _emit

NAMESPACE = "redtail_torch"
DEVICES = ("cpu", "cuda")


@torch.library.custom_op(f"{NAMESPACE}::corr_cost_volume", mutates_args=(),
                         device_types=DEVICES)
def corr_cost_volume(left: torch.Tensor, right: torch.Tensor, max_disp: int,
                     mode: str, groups: int = 1,
                     rows: int = 0) -> torch.Tensor:
    return _corr._forward(left, right, max_disp, mode, groups, rows)


@corr_cost_volume.register_fake
def _(left, right, max_disp, mode, groups=1, rows=0):
    return left.new_empty(
        _corr._out_shape(left, max_disp, mode, groups),
        dtype=left.dtype if mode == "hdw" else torch.float32)


@torch.library.custom_op(f"{NAMESPACE}::cost_volume_concat", mutates_args=(),
                         device_types=DEVICES)
def cost_volume_concat(left: torch.Tensor, right: torch.Tensor,
                       max_disp: int, d_offset: int = 0,
                       d_count: Optional[int] = None) -> torch.Tensor:
    return _concat._forward(left, right, max_disp, d_offset, d_count)


@cost_volume_concat.register_fake
def _(left, right, max_disp, d_offset=0, d_count=None):
    n, h, w, c = left.shape
    d = max_disp - d_offset if d_count is None else d_count
    return left.new_empty((n, d, h, w, 2 * c))


@torch.library.custom_op(f"{NAMESPACE}::fused_cv_emit", mutates_args=(),
                         device_types=DEVICES)
def fused_cv_emit(la: torch.Tensor, rb: torch.Tensor,
                  bias: Optional[torch.Tensor], max_disp: int, elu: bool,
                  layout: str) -> torch.Tensor:
    return _emit._forward(la, rb, bias, max_disp, elu, layout)


@fused_cv_emit.register_fake
def _(la, rb, bias, max_disp, elu, layout):
    n, h, w, k3 = la.shape
    k = k3 // 3
    if layout == "dh_shifted":
        return la.new_empty(
            (n, (max_disp + 1) // 2 + 1, (h + 1) // 2 + 1, w, 4 * k))
    return la.new_empty((n, max_disp, h, w, k))


@torch.library.custom_op(f"{NAMESPACE}::conv223", mutates_args=(),
                         device_types=DEVICES)
def conv223(xp: torch.Tensor, k: torch.Tensor, bias: Optional[torch.Tensor],
            k_layout: str) -> torch.Tensor:
    return _c223._forward(xp, k, bias, k_layout)


@conv223.register_fake
def _(xp, k, bias, k_layout):
    n, dp, hp, w, _ = xp.shape
    kk = k.shape[4] if k_layout == "ck" else k.shape[3]
    return xp.new_empty((n, dp - 1, hp - 1, w, kk))


@torch.library.custom_op(f"{NAMESPACE}::conv3d_k3", mutates_args=(),
                         device_types=DEVICES)
def conv3d_k3(x: torch.Tensor, kt: torch.Tensor,
              bias: torch.Tensor) -> torch.Tensor:
    return _k3._forward(x, kt, bias)


@conv3d_k3.register_fake
def _(x, kt, bias):
    return x.new_empty((*x.shape[:4], kt.shape[3]))


@torch.library.custom_op(f"{NAMESPACE}::deconv3d_s2", mutates_args=(),
                         device_types=DEVICES)
def deconv3d_s2(y: torch.Tensor, kt: torch.Tensor, bias: torch.Tensor,
                skip: Optional[torch.Tensor],
                out_spatial: List[int]) -> torch.Tensor:
    return _d2._forward(y, kt, bias, skip, out_spatial)


@deconv3d_s2.register_fake
def _(y, kt, bias, skip, out_spatial):
    return y.new_empty((y.shape[0], *out_spatial, bias.shape[0]))


# ------------------------------------------------------------ flop formulas
# Tensor arguments arrive as their shapes (`register_flop_formula`).


def corr_flops(left_shape, max_disp: int) -> int:
    """2 C a valid (x, d) pair: the products and sums of the volume (with
    G groups of C channels, 2 C a pair in each group: 2 G C all the same)."""
    n, h, w, c = left_shape
    return 2 * c * n * h * sum(max(w - d, 0) for d in range(max_disp))


def emit_flops(la_shape, max_disp: int) -> int:
    """Per output of the full layout: the S add, the bias add and the ELU
    (exp, select)."""
    n, h, w, k3 = la_shape
    return 4 * n * max_disp * h * w * (k3 // 3)


def conv223_flops(xp_shape, k_shape, k_layout: str) -> int:
    """2 x 12 C a output: the (2, 2, 3) taps' products and sums."""
    n, dp, hp, w, c = xp_shape
    kk = k_shape[4] if k_layout == "ck" else k_shape[3]
    return 2 * 12 * c * n * (dp - 1) * (hp - 1) * w * kk


def conv3d_k3_flops(x_shape, kt_shape) -> int:
    """2 x 27 C a output: the 3 x 3 x 3 taps' products and sums."""
    n, d, h, w, c = x_shape
    return 2 * 27 * c * n * d * h * w * kt_shape[3]


def deconv3d_s2_flops(y_shape, bias_shape) -> int:
    """2 x 27 C c_out an input position: each of the 27 taps' products and
    sums, once per input position (the transposed conv's work)."""
    n, d, h, w, c = y_shape
    return 2 * 27 * c * bias_shape[0] * n * d * h * w


@register_flop_formula(torch.ops.redtail_torch.corr_cost_volume)
def _(left_shape, right_shape, max_disp, mode, *args, out_shape=None,
      **kwargs):
    return corr_flops(left_shape, max_disp)


@register_flop_formula(torch.ops.redtail_torch.cost_volume_concat)
def _(left_shape, right_shape, max_disp, *args, out_shape=None, **kwargs):
    return 0


@register_flop_formula(torch.ops.redtail_torch.fused_cv_emit)
def _(la_shape, rb_shape, bias_shape, max_disp, *args, out_shape=None,
      **kwargs):
    return emit_flops(la_shape, max_disp)


@register_flop_formula(torch.ops.redtail_torch.conv223)
def _(xp_shape, k_shape, bias_shape, k_layout, *args, out_shape=None,
      **kwargs):
    return conv223_flops(xp_shape, k_shape, k_layout)


@register_flop_formula(torch.ops.redtail_torch.conv3d_k3)
def _(x_shape, kt_shape, bias_shape, *args, out_shape=None, **kwargs):
    return conv3d_k3_flops(x_shape, kt_shape)


@register_flop_formula(torch.ops.redtail_torch.deconv3d_s2)
def _(y_shape, kt_shape, bias_shape, *args, out_shape=None, **kwargs):
    return deconv3d_s2_flops(y_shape, bias_shape)
