"""The four forward kernels as `torch.library` custom ops, so `torch.export`
can trace a model through them and an AOTInductor engine can call them.

| op | wrapper | kernel |
| --- | --- | --- |
| `redtail_torch::corr_cost_volume(left, right, max_disp, mode)` | `corr_cost_volume.corr_cost_volume`, `corr_softargmax` | `csrc/corr_cost_volume.cu` (``mode``: `hdw`, `dlast`, `softargmax`) |
| `redtail_torch::cost_volume_concat(left, right, max_disp)` | `cost_volume_concat.cost_volume_concat` | `csrc/cost_volume_concat.cu` |
| `redtail_torch::fused_cv_emit(la, rb, bias, max_disp, elu, layout)` | `fused_cv_emit.fused_cv_emit` | `csrc/fused_cv_emit.cu` (``layout``: `full`, `dh_shifted`) |
| `redtail_torch::conv223(xp, k, bias, k_layout)` | `conv223.conv223` | `csrc/conv223.cu` |

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
the emission 4 per output of the full layout, conv223 2 x 12 C per output.

This module imports only the kernel wrappers: a process that loads an
engine imports it (the package's `kernels/__init__.py` does) and nothing
of the models.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from redtail_tpu_torch.kernels import conv223 as _c223
from redtail_tpu_torch.kernels import corr_cost_volume as _corr
from redtail_tpu_torch.kernels import cost_volume_concat as _concat
from redtail_tpu_torch.kernels import fused_cv_emit as _emit

NAMESPACE = "redtail_torch"
DEVICES = ("cpu", "cuda")


@torch.library.custom_op(f"{NAMESPACE}::corr_cost_volume", mutates_args=(),
                         device_types=DEVICES)
def corr_cost_volume(left: torch.Tensor, right: torch.Tensor, max_disp: int,
                     mode: str) -> torch.Tensor:
    return _corr._forward(left, right, max_disp, mode)


@corr_cost_volume.register_fake
def _(left, right, max_disp, mode):
    n, h, w, _ = left.shape
    shape, dtype = {"dlast": ((n, h, w, max_disp), torch.float32),
                    "hdw": ((n, h, max_disp, w), left.dtype),
                    "softargmax": ((n, h, w), torch.float32)}[mode]
    return left.new_empty(shape, dtype=dtype)


@torch.library.custom_op(f"{NAMESPACE}::cost_volume_concat", mutates_args=(),
                         device_types=DEVICES)
def cost_volume_concat(left: torch.Tensor, right: torch.Tensor,
                       max_disp: int) -> torch.Tensor:
    return _concat._forward(left, right, max_disp)


@cost_volume_concat.register_fake
def _(left, right, max_disp):
    n, h, w, c = left.shape
    return left.new_empty((n, max_disp, h, w, 2 * c))


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


# ------------------------------------------------------------ flop formulas
# Tensor arguments arrive as their shapes (`register_flop_formula`).


def corr_flops(left_shape, max_disp: int) -> int:
    """2 C a valid (x, d) pair: the products and sums of the volume."""
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
