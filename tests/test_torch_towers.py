"""ResNet-18's tower layouts in the port (`models/stereo.py`): the
block-diagonal towers, the H-packed towers and ResNet18-2D's H-packed
correlation head, against the JAX package's under the same switches, on
the CPU.

Each form is selected as in JAX, by ``REDTAIL_TPU_FUSED_TOWERS``,
``REDTAIL_TPU_HPACK2D`` and ``REDTAIL_TPU_HPACK_CORR`` (set for both
packages); the port's context managers select the same forms. Seeded
weights conditioned as `tests/test_torch_stereo.py`'s (random biases),
fp32 on both sides: ResNet18-2D within that file's 1e-4 (sigmoid units),
ResNet-18 3D within the 3D slice's 1e-3 px. Each case also reads the
layer plan, so the form it names is the one that ran, and the plan's
names map onto the JAX profiler's. Then the fallbacks to the batched
towers (int8 leaves, a calibration tap, a trainable net), and image-sharded
block-diagonal and H-packed forwards in gloo ranks against JAX's unsharded
forward (`tests/test_torch_sharding_hpacked.py` has the rest).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from redtail_tpu.models import STEREO_SPECS as JSPECS
from redtail_tpu.models import stereo as jstereo
from redtail_tpu.runtime import layer_profiler as jlp

from redtail_tpu_torch.models import (STEREO_SPECS, init_stereo_params,
                                      params_from_numpy)
from redtail_tpu_torch.ops.convolution import (fused_towers_lowering,
                                               hpack2d_lowering,
                                               hpack_corr_lowering,
                                               plain_lowering)
from redtail_tpu_torch.parallel import rank_checks
from redtail_tpu_torch.parallel.launch import spawn_ranks
from redtail_tpu_torch.quant import (calibrate_stereo,
                                     quantize_stereo_params_int8)
from redtail_tpu_torch.runtime import layer_profiler as lp
from test_torch_stereo import _inputs, conditioned

HW, MAX_DISP = (33, 65), 8
SWITCHES = ("REDTAIL_TPU_FUSED_TOWERS", "REDTAIL_TPU_HPACK2D",
            "REDTAIL_TPU_HPACK_CORR")
FORMS = {"bd": ("1",), "hp": ("1", "1"), "hp+corr": ("1", "1", "1")}
# the tag the towers' layer names carry for (form, s2d frames): H-packing
# needs s2d frames, without them the block-diagonal towers run
TAGS = {("bd", False): "[bd]", ("bd", True): "[bd]", ("hp", False): "[bd]",
        ("hp", True): "[hp]", ("hp+corr", False): "[bd]",
        ("hp+corr", True): "[hp]"}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the tier-1 run puts six test workers on the
    cores (restored after)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, 2))
    yield
    torch.set_num_threads(saved)


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in SWITCHES + ("REDTAIL_TPU_PACKED3D", "REDTAIL_TPU_DFOLD",
                           "REDTAIL_TPU_PALLAS_CONV3D"):
        monkeypatch.delenv(var, raising=False)


def _set_form(monkeypatch, form):
    for var, value in zip(SWITCHES, FORMS.get(form, ())):
        monkeypatch.setenv(var, value)


def _case(name, hw=HW, max_disp=MAX_DISP):
    spec = dataclasses.replace(STEREO_SPECS[name], input_hw=hw,
                               max_disp=max_disp)
    jspec = dataclasses.replace(JSPECS[name], input_hw=hw,
                                max_disp=max_disp)
    return spec, jspec, conditioned(init_stereo_params(spec, seed=0))


def _jax(jspec, params, left, right):
    return np.asarray(jstereo.stereo_forward(
        jspec, jax.tree.map(jnp.asarray, params), jnp.asarray(left),
        jnp.asarray(right)), np.float32)


def _plan(net, left, right):
    with torch.inference_mode():
        entries, out = lp.stereo_layer_plan(net, torch.from_numpy(left),
                                            torch.from_numpy(right))
    return [n for n, *_ in entries], out


def map_names(names):
    """The port's names -> the JAX plan's: batched ``towers_X`` stands for
    ``left_X`` and ``right_X``; a fused corr row for its volume and
    soft-argmax rows; a tagged tower row is JAX's own."""
    mapped = []
    for name in names:
        if name.startswith("towers_") and not name.endswith("]"):
            layer = name[len("towers_"):]
            mapped += [f"left_{layer}", f"right_{layer}"]
        elif name.startswith("corr_cost_volume"):
            mapped += name.split("+")
        else:
            mapped.append(name)
    return mapped


@pytest.mark.parametrize("s2d", [False, True], ids=["raw", "s2d"])
@pytest.mark.parametrize("form", sorted(FORMS))
def test_resnet18_2d_forms_match_jax(monkeypatch, form, s2d):
    spec, jspec, params = _case("resnet18_2d")
    left, right = _inputs(HW, s2d)
    _set_form(monkeypatch, form)
    want = _jax(jspec, params, left, right)
    net = params_from_numpy(spec, params, device="cpu")
    names, got = _plan(net, left, right)
    assert tuple(got.shape) == (1, *HW)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    tag = TAGS[(form, s2d)]
    assert f"towers_conv1{tag}" in names and f"towers_out{tag}" in names
    hp_head = form == "hp+corr" and s2d
    assert ("corr_cost_volume[hp]+softargmax[hp]" in names) == hp_head
    assert ("bneck_unpack[hp]" in names) == hp_head
    assert ("towers_unpack[hp]" in names) == (form == "hp" and s2d)
    # one to one with the JAX profiler's plan under the same switches
    jentries, _ = jlp.stereo_layer_plan(
        jspec, jax.tree.map(jnp.asarray, params), jnp.asarray(left),
        jnp.asarray(right))
    assert map_names(names) == [n for n, *_ in jentries]


@pytest.mark.parametrize("form", ["bd", "hp"])
def test_resnet18_3d_forms_match_jax(monkeypatch, form):
    spec, jspec, params = _case("resnet18")
    left, right = _inputs(HW, s2d=True)
    _set_form(monkeypatch, form)
    want = _jax(jspec, params, left, right)
    net = params_from_numpy(spec, params, device="cpu")
    names, got = _plan(net, left, right)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)
    assert f"towers_out[{form}]" in names


def test_context_managers_select_the_same_forms(monkeypatch):
    spec, _, params = _case("resnet18_2d")
    left, right = _inputs(HW, s2d=True)
    net = params_from_numpy(spec, params, device="cpu")
    by_ctx = {}
    with fused_towers_lowering():
        by_ctx["bd"] = _plan(net, left, right)
        with hpack2d_lowering():
            by_ctx["hp"] = _plan(net, left, right)
            with hpack_corr_lowering():
                by_ctx["hp+corr"] = _plan(net, left, right)
                # plain_lowering() turns every form off
                with plain_lowering():
                    names, _ = _plan(net, left, right)
                    assert "towers_conv1" in names
    for form, (names, out) in by_ctx.items():
        with pytest.MonkeyPatch.context() as mp:
            for var, value in zip(SWITCHES, FORMS[form]):
                mp.setenv(var, value)
            env_names, env_out = _plan(net, left, right)
        assert names == env_names and torch.equal(out, env_out), form


def test_bf16_forms_close_to_the_batched_towers(monkeypatch):
    """bf16 activations through each form (the round-once convs) against
    the batched towers' bf16 forward: the forms round in other places
    (the packed convs add the bias and the ELU before their one rounding,
    as JAX's do), within the bf16 slice gate of a mean 1e-2."""
    spec, _, params = _case("resnet18_2d")
    left, right = _inputs(HW, s2d=True)
    net = params_from_numpy(spec, params, device="cpu", dtype=torch.bfloat16)
    _, ref = _plan(net, left, right)
    for form in sorted(FORMS):
        with pytest.MonkeyPatch.context() as mp:
            for var, value in zip(SWITCHES, FORMS[form]):
                mp.setenv(var, value)
            _, got = _plan(net, left, right)
        assert got.dtype == torch.bfloat16
        assert (got.float() - ref.float()).abs().mean() < 1e-2, form


def test_int8_towers_fall_back_to_the_batch(monkeypatch):
    spec, _, params = _case("resnet18_2d")
    left, right = _inputs(HW, s2d=False)
    scales = calibrate_stereo(spec, params, [(left[0], right[0])],
                              device="cpu")
    net = params_from_numpy(spec, quantize_stereo_params_int8(params, scales),
                            device="cpu")
    assert net.towers_bd is None
    names, ref = _plan(net, left, right)
    _set_form(monkeypatch, "hp+corr")
    got_names, got = _plan(net, left, right)
    assert got_names == names and "towers_conv1" in names
    assert torch.equal(got, ref)


def test_calibration_tap_runs_the_batched_towers(monkeypatch):
    spec, _, params = _case("resnet18_2d")
    left, right = _inputs(HW, s2d=False)
    want = calibrate_stereo(spec, params, [(left[0], right[0])],
                            device="cpu")
    _set_form(monkeypatch, "bd")
    got = calibrate_stereo(spec, params, [(left[0], right[0])],
                           device="cpu")
    assert got == want and "encoder2D/resblock1/res_conv1" in got


def test_trainable_net_falls_back_to_the_batch(monkeypatch):
    spec, _, params = _case("resnet18_2d")
    left, right = _inputs(HW, s2d=False)
    net = params_from_numpy(spec, params, device="cpu", trainable=True)
    assert net.towers_bd is None and net.towers_hp is None
    _set_form(monkeypatch, "bd")
    names, _ = _plan(net, left, right)
    assert "towers_conv1" in names


def _spawn(target, cases, ranks=2):
    return spawn_ranks(target, ranks, backend="gloo", device_type="cpu",
                       args=(cases, "cpu"))


def test_sharded_forms(monkeypatch):
    """One spawn: ResNet18-2D image-sharded over two ranks (rows 17 / 16 of
    33) under block-diagonal towers, and on s2d frames (17 s2d rows, slots
    4 / 5 of 9) under the H-packed towers and head, each against JAX's
    unsharded forward under the same switches, within the sharding tests'
    2e-4."""
    from redtail_tpu_torch.ops.space_to_depth import space_to_depth2_np

    spec, jspec, params = _case("resnet18_2d")
    rs = np.random.RandomState(5)
    left, right = (rs.rand(1, *HW, 3).astype(np.float32) for _ in range(2))
    cases, wants = [], []
    for form, s2d in (("bd", False), ("hp+corr", True)):
        frames = ((space_to_depth2_np(left), space_to_depth2_np(right))
                  if s2d else (left, right))
        _set_form(monkeypatch, form)
        wants.append(_jax(jspec, params, *frames))
        env = {var: value for var, value in zip(SWITCHES, FORMS[form])}
        for var in env:
            monkeypatch.delenv(var)
        cases.append({"spec": {"name": "resnet18_2d", "input_hw": HW,
                               "max_disp": MAX_DISP},
                      "params": params, "left": frames[0],
                      "right": frames[1], "mesh": (1, 2), "mode": "image",
                      "env": env})
    results = _spawn(rank_checks.forward_cases, cases)
    for i, (form, want) in enumerate(zip(("bd", "hp"), wants)):
        for rank, res in enumerate(results):
            assert res[i]["tower_form"] == form, rank
            np.testing.assert_allclose(res[i]["disp"], want, atol=2e-4,
                                       rtol=0, err_msg=f"{form} rank {rank}")
