"""The port's packed 3D head (`models/stereo.py` under `packed3d_lowering()`)
against the JAX package's (`stereo_forward` with ``REDTAIL_TPU_PACKED3D=1``),
on the CPU, for NVTiny, NVSmall and ResNet-18 3D.

Each side takes its final deconv on its off-accelerator branch (unpack +
transposed conv) or, with ``REDTAIL_TPU_DFOLD=1`` on both, the D-folded
deconv with the soft-argmin fused that the card runs. Weights are the
port's seeded numpy init conditioned as `tests/test_torch_stereo.py`
conditions them (random nonzero biases). fp32 on both sides (JAX at
HIGHEST): conv summation order only, through ~20 2D and 3D layers and the
soft-argmin, in pixels: 1e-3 px, the unpacked head's gate.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from redtail_tpu.models import STEREO_SPECS as JSPECS
from redtail_tpu.models import stereo as jstereo
from redtail_tpu.runtime.nodes import StereoNode as JStereoNode

from redtail_tpu_torch.kernels import conv223 as c223
from redtail_tpu_torch.kernels import fused_cv_emit as emit
from redtail_tpu_torch.models import (
    STEREO_SPECS,
    init_stereo_params,
    params_from_numpy,
    params_to_numpy,
    use_packed3d,
)
from redtail_tpu_torch.models import stereo as pstereo
from redtail_tpu_torch.ops.convolution import packed3d_lowering, plain_lowering
from redtail_tpu_torch.runtime import StereoNode
from test_torch_stereo import _inputs, conditioned

MODELS_3D = ("nvtiny", "nvsmall", "resnet18")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in ("REDTAIL_TPU_PACKED3D", "REDTAIL_TPU_DFOLD",
                "REDTAIL_TPU_PALLAS_CONV3D", "REDTAIL_TPU_MASK_FORM",
                "REDTAIL_TPU_MASK_MUL"):
        monkeypatch.delenv(var, raising=False)


def _specs(name, hw, max_disp=8):
    return (dataclasses.replace(STEREO_SPECS[name], input_hw=hw,
                                max_disp=max_disp),
            dataclasses.replace(JSPECS[name], input_hw=hw,
                                max_disp=max_disp))


def _jax_packed(monkeypatch, jspec, params, left, right):
    monkeypatch.setenv("REDTAIL_TPU_PACKED3D", "1")
    try:
        return np.asarray(jstereo.stereo_forward(
            jspec, jax.tree.map(jnp.asarray, params), jnp.asarray(left),
            jnp.asarray(right)), np.float32)
    finally:
        monkeypatch.delenv("REDTAIL_TPU_PACKED3D")


@pytest.fixture
def dfold_spy(monkeypatch):
    """Counts the port's D-folded final deconvs."""
    calls = []
    real = pstereo.conv3d_transpose_dfold

    def spy(*args, **kwargs):
        calls.append(kwargs["h_packed"])
        return real(*args, **kwargs)

    monkeypatch.setattr(pstereo, "conv3d_transpose_dfold", spy)
    return calls


@pytest.mark.parametrize("dfold", [False, True], ids=["unpack", "dfold"])
@pytest.mark.parametrize("s2d", [False, True], ids=["raw", "s2d"])
@pytest.mark.parametrize("hw", [(34, 66), (65, 129)], ids=str)
@pytest.mark.parametrize("name", MODELS_3D)
def test_packed_head_matches_jax_fp32(monkeypatch, dfold_spy, name, hw, s2d,
                                      dfold):
    if dfold:
        monkeypatch.setenv("REDTAIL_TPU_DFOLD", "1")
    spec, jspec = _specs(name, hw)
    params = conditioned(init_stereo_params(spec, seed=0))
    left, right = _inputs(hw, s2d)
    want = _jax_packed(monkeypatch, jspec, params, left, right)
    net = params_from_numpy(spec, params, device="cpu")
    with packed3d_lowering():
        got = net(torch.from_numpy(left), torch.from_numpy(right))
    assert dfold_spy == ([True] if dfold else [])   # dh layout into dfold
    assert tuple(got.shape) == (1, *hw) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)
    assert 0 <= got.min() and got.max() <= spec.full_max_disp


@pytest.mark.parametrize("name", MODELS_3D)
def test_packed_head_matches_unpacked_head(name):
    """Packed and unpacked are one function (fp32 order only), on both
    final-deconv branches."""
    spec, _ = _specs(name, (65, 129))
    net = params_from_numpy(spec, conditioned(init_stereo_params(spec)),
                            device="cpu")
    left, right = (torch.from_numpy(a) for a in _inputs((65, 129), False))
    unpacked = net(left, right).numpy()
    with packed3d_lowering():
        packed = net(left, right).numpy()
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("REDTAIL_TPU_DFOLD", "1")
            dfold = net(left, right).numpy()
    np.testing.assert_allclose(packed, unpacked, atol=1e-4)
    np.testing.assert_allclose(dfold, unpacked, atol=1e-4)


def test_packed_head_bf16_close_to_jax_fp32(monkeypatch):
    monkeypatch.setenv("REDTAIL_TPU_DFOLD", "1")
    hw = (65, 129)
    spec, jspec = _specs("nvsmall", hw)
    params = conditioned(init_stereo_params(spec, seed=0))
    left, right = _inputs(hw, s2d=True)
    want = _jax_packed(monkeypatch, jspec, params, left, right)
    net = params_from_numpy(spec, params, device="cpu", dtype=torch.bfloat16)
    with packed3d_lowering():
        got = net(torch.from_numpy(left), torch.from_numpy(right))
    assert got.dtype == torch.bfloat16
    # bf16 activations and weights through the whole net, in pixels of a
    # 0..16 px range: the unpacked head's bf16 gate
    # (tests/test_torch_stereo3d.py::test_forward_bf16_close_to_jax_fp32)
    assert np.abs(got.float().numpy() - want).mean() < 0.05


def test_selection_precedence(monkeypatch):
    """`packed3d_lowering()` or ``REDTAIL_TPU_PACKED3D=1`` select the packed
    head, the default is off, `plain_lowering()` wins over both."""
    assert not use_packed3d()
    monkeypatch.setenv("REDTAIL_TPU_PACKED3D", "1")
    assert use_packed3d()
    with plain_lowering():
        assert not use_packed3d()
    monkeypatch.setenv("REDTAIL_TPU_PACKED3D", "0")
    assert not use_packed3d()
    with packed3d_lowering():
        assert use_packed3d()
        with plain_lowering():
            assert not use_packed3d()
        assert use_packed3d()
    assert not use_packed3d()


@pytest.mark.parametrize("name", MODELS_3D)
def test_packed_plan_matches_jax_policy(name):
    """The layer plan walks the JAX policy: the layouts each model's
    layers take (`redtail_tpu/models/stereo.py:459-540`)."""
    plan = {s.name: (s.op, s.layout) for s in
            pstereo._packed_plan(STEREO_SPECS[name])}
    if name == "resnet18":
        assert plan["conv3D_1b"] == ("conv", "dh")
        assert plan["conv3D_2ds"] == ("down", "d")
        assert plan["conv3D_4ds"] == ("down_unpack", "none")
        assert plan["conv3D_5b"] == ("native", "none")
        assert plan["deconv3D_4"] == ("deconv", "dh")
        assert plan["deconv3D_5"] == ("final", "dh")
    else:
        assert plan["conv3D_2"] == ("conv", "dh")
        assert plan["conv3D_3ds"] == ("down", "d")
        # NVTiny's 64-channel conv3D_6ds still fits 2 x 64 = 128 packed
        assert plan["conv3D_6ds"] == (("down", "d") if name == "nvtiny"
                                      else ("down_unpack", "none"))
        assert plan["conv3D_8"] == (("conv", "d") if name == "nvtiny"
                                    else ("native", "none"))
        assert plan["deconv3D_1"] == ("deconv", "d")
        assert plan["deconv3D_3"] == ("final", "dh")
    # exactly one in-shifted, H-packed conv: one conv223 launch per frame
    assert sum(s.op == "conv" and s.packed_h and s.in_shifted for s in
               pstereo._packed_plan(STEREO_SPECS[name])) == 1


def test_stereo_node_serves_the_packed_head_like_jax(monkeypatch):
    """`StereoNode` under the JAX package's switch (``REDTAIL_TPU_PACKED3D=1``
    on both sides): the packed head, the emission in its packed layout and
    one conv223 call (plain version on the CPU, so no launch counted)."""
    monkeypatch.delenv("REDTAIL_TPU_S2D", raising=False)  # JAX: raw stem
    hw = (65, 129)
    spec, jspec = _specs("nvtiny", hw)
    params = conditioned(init_stereo_params(spec, seed=1))
    rs = np.random.RandomState(3)
    left, right = (rs.randint(0, 256, hw + (3,)).astype(np.uint8)
                   for _ in range(2))
    monkeypatch.setenv("REDTAIL_TPU_PACKED3D", "1")
    want = JStereoNode(jspec, jax.tree.map(jnp.asarray, params),
                       dtype=jnp.float32)(left, right)
    calls = []
    real = c223.conv223
    monkeypatch.setattr(pstereo.P, "conv223",
                        lambda *a: calls.append(1) or real(*a))
    packed_emits = []
    real_emit = emit.fused_cv_emit

    def emit_spy(*args, **kwargs):
        packed_emits.append(kwargs.get("layout"))
        return real_emit(*args, **kwargs)

    monkeypatch.setattr("redtail_tpu_torch.ops.fused_cost_volume_conv."
                        "fused_cv_emit", emit_spy)
    node = StereoNode(spec, params, dtype=torch.float32, device="cpu")
    got = node(left, right)
    assert calls == [1] and packed_emits == ["dh_shifted"]
    assert got.shape == hw and got.dtype == np.float32
    # raw 5x5 stem (JAX) against the s2d 3x3 stem (port): reassociated fp32
    # sums, in pixels (as tests/test_torch_serving.py)
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_packed_kernels_leave_the_state_layout_unchanged():
    """The band kernels are non-persistent buffers derived at load: the
    weights carried across are exactly the JAX dict's, and the state dict
    holds only the spec's layers."""
    spec = STEREO_SPECS["nvsmall"]
    params = conditioned(init_stereo_params(spec, seed=5))
    net = params_from_numpy(spec, params, device="cpu")
    jax.tree.map(np.testing.assert_array_equal, params_to_numpy(net), params)
    assert not [k for k in net.state_dict() if k.startswith("packed3D")]
    assert len(net.packed3D) == len(spec.enc3d) + len(spec.dec3d) - 1 - 2
