"""The four forward kernels as `torch.library` custom ops (`kernels/_ops.py`)
and what `torch.export` makes of the serving configurations, on the CPU,
without compiling (`tests/test_torch_engine_aoti.py` compiles).

- Every serving configuration of `stereo_app` (ResNet18-2D; the 3D models
  under the fused, plain and packed heads; fp32, bf16, and the w8 and int8
  rungs under the packed head) exports, and the exported program is
  bit-equal to the eager model under inference mode and holds the expected
  `redtail_torch::` ops.
- Each op's fake implementation gives its plain version's shape and dtype
  at the edge shapes `chip_smoke.py` phase 3 takes the kernels through (the
  plain versions on the meta device), its CPU implementation equals the
  plain version, and its flop formula is the count `chip_smoke.py` bounds
  the kernel with.
- `load_engine` refuses an engine of another device type or another card;
  the conv switches an engine call sets are restored after it;
  `enable_compilation_cache` keys its directory by the device.
"""

import contextlib
import dataclasses
import json

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

import chip_smoke
from redtail_tpu_torch.apps import stereo_app
from redtail_tpu_torch.kernels import _ops
from redtail_tpu_torch.kernels import conv223 as c223
from redtail_tpu_torch.kernels import corr_cost_volume as corr
from redtail_tpu_torch.kernels import cost_volume_concat as concat
from redtail_tpu_torch.kernels import fused_cv_emit as emit
from redtail_tpu_torch.models import (STEREO_SPECS, init_stereo_params,
                                      params_from_numpy)
from redtail_tpu_torch.ops.convolution import (packed3d_lowering,
                                               plain_lowering)
from redtail_tpu_torch.ops.space_to_depth import space_to_depth2_np
from redtail_tpu_torch.runtime import cache
from test_torch_stereo import conditioned

HW = (34, 66)
# (model, head, rung) of every serving configuration: fp32 and bf16 under
# each head, w8 and int8 (bf16) under the packed head as `stereo_app`'s
# rungs run them; ResNet18-2D has one head
CONFIGS = ([("resnet18_2d", "corr", rung)
            for rung in ("fp32", "bf16", "w8", "int8")]
           + [(name, head, rung) for name in ("nvtiny", "nvsmall", "resnet18")
              for head, rung in (("fused", "fp32"), ("fused", "bf16"),
                                 ("plain", "fp32"), ("plain", "bf16"),
                                 ("packed", "fp32"), ("packed", "bf16"),
                                 ("packed", "w8"), ("packed", "int8"))])
EXPECTED_OPS = {"corr": {"redtail_torch.corr_cost_volume.default"},
                "fused": {"redtail_torch.fused_cv_emit.default"},
                "plain": {"redtail_torch.cost_volume_concat.default"},
                "packed": {"redtail_torch.fused_cv_emit.default",
                           "redtail_torch.conv223.default"}}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """A few intra-op threads, so that parallel test workers do not
    oversubscribe the cores (restored after)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, 2))
    yield
    torch.set_num_threads(saved)


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in ("REDTAIL_TPU_PACKED3D", "REDTAIL_TPU_DFOLD"):
        monkeypatch.delenv(var, raising=False)


def serving_net(name, rung):
    """The net and frames of one rung, as `stereo_app` builds them: the
    tree rounded to the dtype and quantized; frames s2d-packed unless the
    stem is int8."""
    spec = dataclasses.replace(STEREO_SPECS[name], input_hw=HW, max_disp=8)
    dtype = torch.float32 if rung == "fp32" else torch.bfloat16
    rs = np.random.RandomState(3)
    left, right = (torch.from_numpy(rs.rand(1, *HW, 3).astype(np.float32))
                   .to(dtype).float().numpy() for _ in range(2))
    tree = stereo_app.quantized_tree(
        spec, conditioned(init_stereo_params(spec, seed=1)),
        rung if rung in ("w8", "int8") else None, dtype, "cpu", left, right)
    net = params_from_numpy(spec, tree, device="cpu", dtype=dtype)
    frames = stereo_app.serving_frames(left, right, s2d=rung != "int8")
    return net, tuple(torch.from_numpy(f).to(dtype) for f in frames)


@pytest.mark.parametrize("name,head,rung", CONFIGS,
                         ids=["-".join(c) for c in CONFIGS])
def test_export_is_bit_equal_and_holds_the_kernels(name, head, rung):
    net, frames = serving_net(name, rung)
    ctx = {"plain": plain_lowering,
           "packed": packed3d_lowering}.get(head, contextlib.nullcontext)
    with ctx():
        ep = cache._export(net, frames)
        with torch.inference_mode():
            want = net(*frames)
            got = ep.module()(*frames)
    assert torch.equal(got, want)
    ops = {str(n.target) for n in ep.graph.nodes
           if str(n.target).startswith("redtail_torch.")}
    assert ops == EXPECTED_OPS[head]


def test_export_copies_an_example_passed_twice():
    """One zero frame for both sides must not tie the two inputs."""
    net, (left, right) = serving_net("resnet18_2d", "fp32")
    zero = torch.zeros_like(left)
    ep = cache._export(net, (zero, zero))
    with torch.inference_mode():
        assert torch.equal(ep.module()(left, right), net(left, right))


# ------------------------------------------------------------------ the ops

def _corr_args(case, dtype, device, mode):
    _, shape, d = case
    return (torch.randn(shape, device=device).to(dtype),
            torch.randn(shape, device=device).to(dtype), d, mode)


def _emit_args(case, dtype, device, layout):
    _, (n, h, w, k), d = case
    return (torch.randn((n, h, w, 3 * k), device=device).to(dtype),
            torch.randn((n, h, w, 6 * k), device=device).to(dtype),
            torch.randn((k,), device=device), d, True, layout)


def _conv223_args(case, dtype, device, k_layout):
    _, xshape, k_out = case
    c = xshape[-1]
    kshape = (2, 2, 3, c, k_out) if k_layout == "ck" else (2, 2, 3, k_out, c)
    return (torch.randn(xshape, device=device).to(dtype),
            torch.randn(kshape, device=device).to(dtype),
            torch.randn((k_out,), device=device), k_layout)


def _plain(kernel, args):
    if kernel == "corr":
        left, right, d, mode = args
        if mode == "softargmax":
            return corr.corr_softargmax_plain(left, right, d)
        return corr.corr_cost_volume_plain(left, right, d, layout=mode)
    if kernel == "concat":
        return concat.cost_volume_concat_plain(*args)
    if kernel == "emit":
        la, rb, bias, d, elu, layout = args
        return emit.fused_cv_emit_plain(la, rb, bias, d, elu=elu,
                                        layout=layout)
    xp, k, bias, k_layout = args
    return c223.conv223_plain(
        xp, k if k_layout == "ck" else c223.contract_weights(k), bias)


OP = {"corr": torch.ops.redtail_torch.corr_cost_volume,
      "concat": torch.ops.redtail_torch.cost_volume_concat,
      "emit": torch.ops.redtail_torch.fused_cv_emit,
      "conv223": torch.ops.redtail_torch.conv223}
EDGES = ([("corr", case, form) for case in chip_smoke.CORR_CASES
          for form in corr.MODES]
         + [("concat", case, None) for case in chip_smoke.CONCAT_CASES]
         + [("emit", case, form) for case in chip_smoke.EMIT_CASES
            for form in emit.LAYOUTS]
         + [("conv223", case, form) for case in chip_smoke.CONV223_CASES
            for form in c223.K_LAYOUTS])


def _args(kernel, case, form, dtype, device):
    if kernel == "corr":
        return _corr_args(case, dtype, device, form)
    if kernel == "concat":
        _, shape, d = case
        return (torch.randn(shape, device=device).to(dtype),
                torch.randn(shape, device=device).to(dtype), d)
    if kernel == "emit":
        return _emit_args(case, dtype, device, form)
    return _conv223_args(case, dtype, device, form)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("kernel,case,form", EDGES,
                         ids=[f"{k}-{c[0]}-{f}" for k, c, f in EDGES])
def test_fake_impl_gives_the_plain_shape_and_dtype(kernel, case, form,
                                                   dtype):
    want = _plain(kernel, _args(kernel, case, form, dtype, "meta"))
    with FakeTensorMode():
        got = OP[kernel](*_args(kernel, case, form, dtype, "cpu"))
    assert (tuple(got.shape), got.dtype) == (tuple(want.shape), want.dtype)


SMALL = [(k, c, f) for k, c, f in EDGES
         if np.prod(c[1]) <= 40_000 and c[0] not in ("flagship",)]


@pytest.mark.parametrize("kernel,case,form", SMALL,
                         ids=[f"{k}-{c[0]}-{f}" for k, c, f in SMALL])
def test_cpu_impl_is_the_plain_version(kernel, case, form):
    torch.manual_seed(0)
    args = _args(kernel, case, form, torch.float32, "cpu")
    assert torch.equal(OP[kernel](*args), _plain(kernel, args))


@pytest.mark.parametrize("kernel,case,form", [
    ("corr", chip_smoke.CORR_CASES[1], "dlast"),
    ("corr", chip_smoke.CORR_CASES[2], "softargmax"),
    ("concat", chip_smoke.CONCAT_CASES[2], None),
    ("emit", chip_smoke.EMIT_CASES[3], "dh_shifted"),
    ("conv223", chip_smoke.CONV223_CASES[3], "ck"),
    ("conv223", chip_smoke.CONV223_CASES[3], "kc")],
    ids=lambda v: v if isinstance(v, str) else None)
def test_flop_formula_is_the_bound_count(kernel, case, form):
    """The counts `chip_smoke.py` bounds each kernel with: 2 C per valid
    (x, d) pair, none for the concat copy, 4 per full-layout output of the
    emission, 2 x 12 C per conv223 output."""
    args = _args(kernel, case, form, torch.float32, "cpu")
    with FlopCounterMode(display=False) as counter:
        OP[kernel](*args)
    if kernel == "corr":
        n, h, w, c = args[0].shape
        want = 2 * c * n * h * sum(max(w - k, 0) for k in range(args[2]))
    elif kernel == "concat":
        want = 0
    elif kernel == "emit":
        n, h, w, k3 = args[0].shape
        want = 4 * n * args[3] * h * w * (k3 // 3)
    else:
        n, dp, hp, w, c = args[0].shape
        want = 2 * 12 * c * n * (dp - 1) * (hp - 1) * w * case[2]
    assert counter.get_total_flops() == want


def test_the_ops_carry_no_gradient_the_wrappers_do():
    """Autograd stays the wrappers': the op itself refuses a backward, the
    wrapper on the CPU is differentiable."""
    left = torch.randn(1, 3, 8, 4, requires_grad=True)
    right = torch.randn(1, 3, 8, 4)
    out = torch.ops.redtail_torch.corr_cost_volume(left, right, 3, "dlast")
    with pytest.raises(RuntimeError, match="autograd"):
        out.sum().backward()
    corr.corr_cost_volume(left, right, 3).sum().backward()
    assert left.grad is not None


# ---------------------------------------------------------- cache and loader


def _sidecar(path, device, card=None):
    path.write_bytes(b"")
    (path.parent / (path.name + ".json")).write_text(json.dumps(
        {"version": 1, "device": device, "card": card, "torch": "x",
         "switches": None, "ops": [], "extras": {}}))


def test_load_engine_refuses_another_device(tmp_path, monkeypatch):
    path = tmp_path / "e.pt2"
    _sidecar(path, "cuda", "NVIDIA H100 80GB HBM3")
    with pytest.raises(ValueError, match="built for 'cuda'.*'cpu'"):
        cache.load_engine(path, device="cpu")
    _sidecar(path, "cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cache.load_engine(path)   # the default is the card, and none is here
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="built for 'cpu'.*'cuda'"):
        cache.load_engine(path)
    _sidecar(path, "cuda", "NVIDIA A100-SXM4-80GB")
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 80GB HBM3")
    with pytest.raises(ValueError, match="built on 'NVIDIA A100"):
        cache.load_engine(path)


def test_engine_call_sets_and_restores_the_conv_switches():
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)
    stored = {"cudnn.allow_tf32": not flags[0],
              "matmul.allow_tf32": not flags[1],
              "cudnn.deterministic": True}
    with cache._switches(stored):
        assert (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.deterministic) == tuple(stored.values())
    assert (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.deterministic) == flags


def test_enable_compilation_cache_keys_by_device(tmp_path, monkeypatch):
    monkeypatch.delenv("TORCHINDUCTOR_CACHE_DIR", raising=False)
    import torch._inductor.config as inductor_config
    monkeypatch.setattr(inductor_config, "fx_graph_cache",
                        inductor_config.fx_graph_cache)
    path = cache.enable_compilation_cache(str(tmp_path), device="cpu")
    assert path == cache.enable_compilation_cache(str(tmp_path),
                                                  device="cpu")
    assert path.startswith(str(tmp_path / "cpu-"))
    import os
    assert os.environ["TORCHINDUCTOR_CACHE_DIR"] == path
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cache.enable_compilation_cache(str(tmp_path))


def test_openmp_compiles():
    assert not cache.openmp_compiles("/nonexistent/g++")


def test_cpp_compiler_falls_back_to_the_system_gcc(monkeypatch):
    """Where Inductor's compiler cannot build OpenMP, the engine build
    takes the g++ on PATH; where that cannot either, it raises."""
    import torch._inductor.config as inductor_config
    from torch._inductor import cpp_builder

    monkeypatch.setattr(inductor_config.cpp, "cxx", inductor_config.cpp.cxx)
    monkeypatch.setattr(cpp_builder, "get_cpp_compiler",
                        lambda: "/toolchain/bin/g++")
    monkeypatch.setattr(cache.shutil, "which", lambda name: "/usr/bin/g++")
    monkeypatch.setattr(cache, "openmp_compiles",
                        lambda compiler: compiler == "/usr/bin/g++")
    assert cache.cpp_compiler() == "/usr/bin/g++"
    assert inductor_config.cpp.cxx == (None, "/usr/bin/g++")
    monkeypatch.setattr(cache, "openmp_compiles", lambda compiler: False)
    with pytest.raises(RuntimeError, match="builds OpenMP"):
        cache.cpp_compiler()
