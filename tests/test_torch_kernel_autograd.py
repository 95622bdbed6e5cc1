"""The CUDA kernel wrappers refuse autograd, on the CPU.

No kernel has a backward yet, and each writes its output through a raw
pointer, so on the card a loss through one would silently lose the
gradients of every layer upstream. Each of the five wrapper entry points
must raise before it launches when grad mode is on and an input requires
grad, and launch as before under `torch.no_grad()` / `inference_mode()`.
Here the CUDA route is taken on CPU tensors by monkeypatching the
wrapper's `_on_cpu`, with `_lib` replaced by a stand-in that records the
launch; `tests/test_torch_cuda.py` holds the same on the card. The CPU
plain versions stay differentiable.
"""

import pytest
import torch

from redtail_tpu_torch.kernels import conv223 as c223
from redtail_tpu_torch.kernels import corr_cost_volume as corr
from redtail_tpu_torch.kernels import cost_volume_concat as concat
from redtail_tpu_torch.kernels import fused_cv_emit as emit


class Launched(Exception):
    """Raised by the stand-in `_lib`: the wrapper reached its launch."""


def _inputs(name, requires_grad):
    gen = torch.Generator().manual_seed(0)

    def t(*shape):
        return torch.randn(shape, generator=gen).requires_grad_(requires_grad)

    if name in ("corr_cost_volume", "corr_softargmax", "cost_volume_concat"):
        return (t(1, 3, 8, 4), t(1, 3, 8, 4), 3)
    if name == "fused_cv_emit":
        return (t(1, 3, 8, 6), t(1, 3, 8, 12), t(2), 3)
    return (t(1, 3, 4, 5, 16), t(2, 2, 3, 16, 16), t(16))  # conv223


ENTRY = {"corr_cost_volume": (corr, corr.corr_cost_volume),
         "corr_softargmax": (corr, corr.corr_softargmax),
         "cost_volume_concat": (concat, concat.cost_volume_concat),
         "fused_cv_emit": (emit, emit.fused_cv_emit),
         "conv223": (c223, c223.conv223)}


@pytest.fixture
def cuda_route(monkeypatch):
    """Every wrapper takes its CUDA route; reaching `_lib` raises
    `Launched`."""
    def launch():
        raise Launched

    for module in (corr, concat, emit, c223):
        monkeypatch.setattr(module, "_on_cpu", lambda *args: False)
        monkeypatch.setattr(module, "_lib", launch)


@pytest.mark.parametrize("name", list(ENTRY))
def test_refuses_before_launch_when_grad_is_needed(name, cuda_route):
    _, fn = ENTRY[name]
    before = fn.launches
    with pytest.raises(RuntimeError, match=r"no backward yet.*item 9"):
        fn(*_inputs(name, True))
    assert fn.launches == before


@pytest.mark.parametrize("mode", ["no_grad", "inference_mode",
                                  "no_input_requires_grad"])
@pytest.mark.parametrize("name", list(ENTRY))
def test_launches_when_no_grad_is_needed(name, mode, cuda_route):
    _, fn = ENTRY[name]
    ctx = {"no_grad": torch.no_grad, "inference_mode": torch.inference_mode,
           "no_input_requires_grad": torch.enable_grad}[mode]
    with ctx(), pytest.raises(Launched):
        fn(*_inputs(name, mode != "no_input_requires_grad"))


@pytest.mark.parametrize("name", list(ENTRY))
def test_plain_versions_stay_differentiable(name):
    _, fn = ENTRY[name]
    args = _inputs(name, True)
    out = fn(*args)
    assert out.grad_fn is not None
    out.float().square().sum().backward()
    for a in args:
        if isinstance(a, torch.Tensor):
            assert a.grad is not None and torch.isfinite(a.grad).all()
