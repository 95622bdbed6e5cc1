"""The CUDA kernel wrappers under autograd, on the CPU.

The correlation and concat volumes have backward kernels: where grad mode
is on and an input requires grad, their wrappers run as autograd functions
whose backward launches the backward kernel on CUDA tensors. The emission
and conv223 kernels have none yet, and each writes its output through a
raw pointer, so on the card a loss through one would silently lose the
gradients of every layer upstream: those two wrappers must raise before
they launch when grad mode is on and an input requires grad. All five
launch as before under `torch.no_grad()` / `inference_mode()`. Here the
CUDA route is taken on CPU tensors by monkeypatching the wrapper's
`_on_cpu`, with `_lib` (and `_lib_bwd`) replaced by stand-ins that record
the launch; `tests/test_torch_cuda.py` holds the same on the card. The CPU
plain versions stay differentiable.
"""

from types import SimpleNamespace

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


@pytest.mark.parametrize("name", ["fused_cv_emit", "conv223"])
def test_refuses_before_launch_when_grad_is_needed(name, cuda_route):
    _, fn = ENTRY[name]
    before = fn.launches
    with pytest.raises(RuntimeError, match=r"no backward yet.*item 2"):
        fn(*_inputs(name, True))
    assert fn.launches == before


class FakeLib:
    """A stand-in kernel library: each ``*_launch`` records its arguments
    and returns 0 (success) without touching the output."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.endswith("_launch"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


# (entry, keywords, backward counter, the backward kernel's mode argument)
BACKWARD = {
    "corr_cost_volume-dlast": ("corr_cost_volume", {"layout": "dlast"},
                               corr.corr_cost_volume_bwd, 1),
    "corr_cost_volume-hdw": ("corr_cost_volume", {"layout": "hdw"},
                             corr.corr_cost_volume_bwd, 0),
    "corr_softargmax": ("corr_softargmax", {}, corr.corr_softargmax_bwd, 2),
    "cost_volume_concat": ("cost_volume_concat", {},
                           concat.cost_volume_concat_bwd, None),
}


@pytest.mark.parametrize("case", list(BACKWARD))
def test_cuda_route_launches_the_backward_kernel(case, monkeypatch):
    """With grad needed, the forward launches its kernel once and the
    backward the backward kernel once, on the cotangent and the saved
    features; the grads come back in the inputs' shapes and dtype."""
    name, kw, bwd, mode = BACKWARD[case]
    module, fn = ENTRY[name]
    lib, lib_bwd = FakeLib(), FakeLib()
    monkeypatch.setattr(module, "_on_cpu", lambda *args: False)
    monkeypatch.setattr(module, "_lib", lambda: lib)
    monkeypatch.setattr(module, "_lib_bwd", lambda: lib_bwd)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=0))
    left, right, d = _inputs(name, True)
    before = (fn.launches, bwd.launches)
    out = fn(left, right, d, **kw)
    assert [c[0] for c in lib.calls] == [f"{module.__name__.rsplit('.')[-1]}"
                                         "_launch"]
    g = torch.ones_like(out)
    out.backward(g)
    assert (fn.launches, bwd.launches) == (before[0] + 1, before[1] + 1)
    assert len(lib_bwd.calls) == 1
    call, args = lib_bwd.calls[0]
    assert call.endswith("_bwd_launch")
    if mode is None:  # concat: (g, dL, dR, n, h, w, c, D, bf16, word, ...)
        assert args[0] == g.data_ptr() and args[3:8] == (1, 3, 8, 4, d)
        assert args[9] == concat.bwd_tile_plan(8, 4, d, left.dtype).word
    else:  # corr: (L, R, g, dL, dR, n, h, w, c, D, bf16, mode, seg, ...)
        assert args[:2] == (left.data_ptr(), right.data_ptr())
        assert args[5:10] == (1, 3, 8, 4, d) and args[11] == mode
        # one launch, no scratch volume: the pointers are L, R, g, dL, dR
        form = {v: k for k, v in corr.MODES.items()}[mode]
        assert args[12] == corr.bwd_tile_plan(8, 4, d, left.dtype, form).seg
        assert len(args) == 15 and all(a is not None for a in args[:5])
    for t in (left, right):
        assert t.grad is not None and t.grad.shape == t.shape
        assert t.grad.dtype == t.dtype


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
