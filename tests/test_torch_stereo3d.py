"""The port's 3D concat-volume models (NVTiny, NVSmall, ResNet-18 3D) and
their operators against the JAX package's, on the CPU.

Conv3d and its transpose are held against JAX and the in-repo TF golden
fixtures, soft-argmin against its fixtures, and the three models end to end
under both lowerings: the default fused cost volume + conv3D_1 and
`plain_lowering()` (explicit concat volume + dense conv3d), each against
JAX under its own same lowering. The JAX side is pinned to its unpacked 3D
path (``REDTAIL_TPU_PACKED3D=0``, as `tests/test_packed3d.py:361` does), so
the reference is the path the port computes whatever the environment.
Weights are the port's seeded numpy init conditioned as
`tests/test_torch_stereo.py` conditions them (random biases, scaled
residual-branch and feature-head weights); the 3D head needs nothing more.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from redtail_tpu import ops as jops
from redtail_tpu.models import STEREO_SPECS as JSPECS
from redtail_tpu.models import stereo as jstereo
from redtail_tpu.ops.convolution import plain_lowering as jplain_lowering

from conftest import LOCAL_GOLDEN_DIR
from redtail_tpu_torch import ops
from redtail_tpu_torch.io import read_bin
from redtail_tpu_torch.models import (
    STEREO_SPECS,
    StereoNet,
    init_stereo_params,
    params_from_npz,
    params_from_numpy,
    params_to_numpy,
    stereo_forward,
)
from redtail_tpu_torch.ops.convolution import (
    plain_lowering,
    use_plain_lowering,
)
from test_torch_stereo import _inputs, conditioned

MODELS_3D = ("nvtiny", "nvsmall", "resnet18")
LOWERINGS = ("fused", "plain")


@pytest.fixture(autouse=True)
def _unpacked_jax(monkeypatch):
    monkeypatch.setenv("REDTAIL_TPU_PACKED3D", "0")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _golden(name):
    return read_bin(LOCAL_GOLDEN_DIR / f"{name}.bin")


def _ndchw(a):  # golden NDCHW -> NDHWC
    return np.transpose(a, (0, 1, 3, 4, 2))


def _ncdhw(a):  # golden NCDHW -> NDHWC
    return np.transpose(a, (0, 2, 3, 4, 1))


def _kvcrs(a):  # golden KVCRS -> DHWIO
    return np.transpose(a, (1, 3, 4, 2, 0))


# --------------------------------------------------------------- conv3d

# case -> (strides, padding): tests/test_ops_golden.py:CONV3D_CASES
CONV3D_CASES = {"01": ((1, 1, 1), "VALID"), "02": ((1, 2, 2), "SAME"),
                "03": ((1, 2, 2), "SAME"), "05": ((2, 2, 2), "SAME")}


@pytest.mark.parametrize("case", sorted(CONV3D_CASES))
def test_conv3d_golden(case):
    strides, padding = CONV3D_CASES[case]
    x = _ndchw(_golden(f"conv3d_{case}_x"))
    w = _kvcrs(_golden(f"conv3d_{case}_w"))
    want = _ndchw(_golden(f"conv3d_{case}_y"))
    got = ops.conv3d(_t(x), _t(w), strides=strides, padding=padding).numpy()
    # the JAX package's gate for the same fixtures (rtol = atol = 1e-4)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_conv3d_bias_elu_golden():
    x = _ndchw(_golden("conv3d_06_x"))
    w = _kvcrs(_golden("conv3d_06_w"))
    want = _ndchw(_golden("conv3d_06_y"))
    got = ops.elu(ops.conv3d(_t(x), _t(w), _t(_golden("conv3d_06_b")),
                             strides=(2, 2, 2)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_conv3d_two_layer_golden():
    x = _ndchw(_golden("conv3d_07_x"))
    w = _t(_kvcrs(_golden("conv3d_07_w")))
    y = ops.conv3d(ops.conv3d(_t(x), w), w, strides=(2, 2, 2))
    np.testing.assert_allclose(y.numpy(), _ndchw(_golden("conv3d_07_y")),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("strides", [(1, 1, 1), (2, 2, 2), (1, 2, 2)],
                         ids=str)
@pytest.mark.parametrize("dhw", [(8, 9, 11), (7, 10, 12)], ids=str)
def test_conv3d_matches_jax(dhw, strides):
    """Even D at stride 2 pads (0, 1), odd D (1, 1): both TF-SAME forms."""
    rs = np.random.RandomState(0)
    x = rs.randn(2, *dhw, 5).astype(np.float32)
    w = (rs.randn(3, 3, 3, 5, 6) * 0.3).astype(np.float32)
    b = rs.randn(6).astype(np.float32)
    want = np.asarray(jops.conv3d(x, w, b, strides=strides))
    got = ops.conv3d(_t(x), _t(w), _t(b), strides=strides)
    assert tuple(got.shape) == want.shape
    # both full fp32 (JAX at HIGHEST); only the summation order differs
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_conv3d_bf16_matches_jax():
    rs = np.random.RandomState(1)
    x = rs.randn(1, 8, 9, 11, 4).astype(np.float32)
    w = (rs.randn(3, 3, 3, 4, 6) * 0.3).astype(np.float32)
    b = rs.randn(6).astype(np.float32)
    j = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    want = np.asarray(jops.conv3d(j(x), j(w), j(b), strides=(2, 2, 2)),
                      np.float32)
    got = ops.conv3d(_t(x).bfloat16(), _t(w).bfloat16(), _t(b).bfloat16(),
                     strides=(2, 2, 2))
    assert got.dtype == torch.bfloat16
    # as tests/test_torch_ops.py::test_conv2d: the port rounds the conv
    # output to bf16 before the fp32 bias add, JAX only after it
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2, atol=ulp)


# case -> (y layout, strides, padding, forward input shape NDHWC):
# tests/test_ops_golden.py:CONV3D_TRAN_CASES
CONV3D_TRAN_CASES = {
    "01": (_ndchw, (1, 1, 1), "VALID", (1, 1, 3, 3, 3)),
    "02": (_ndchw, (1, 2, 2), "SAME", (1, 1, 5, 5, 3)),
    "03": (_ncdhw, (2, 2, 2), "SAME", (1, 8, 9, 9, 4)),
}


@pytest.mark.parametrize("case", sorted(CONV3D_TRAN_CASES))
def test_conv3d_transpose_golden(case):
    layout, strides, padding, x_shape = CONV3D_TRAN_CASES[case]
    y = layout(_golden(f"conv3d_tran_{case}_y"))
    w = _kvcrs(_golden(f"conv3d_tran_{case}_w"))
    want = _ndchw(_golden(f"conv3d_tran_{case}_x"))
    got = ops.conv3d_transpose(_t(y), _t(w), out_spatial=x_shape[1:4],
                               strides=strides, padding=padding)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_conv3d_transpose_bias_elu_golden():
    y = _ncdhw(_golden("conv3d_tran_04_y"))
    w = _kvcrs(_golden("conv3d_tran_04_w"))
    got = ops.elu(ops.conv3d_transpose(
        _t(y), _t(w), _t(_golden("conv3d_tran_04_b")), out_spatial=(8, 9, 9)))
    np.testing.assert_allclose(got.numpy(), _ndchw(_golden("conv3d_tran_04_x")),
                               rtol=1e-4, atol=1e-4)


def test_conv3d_transpose_two_layer_golden():
    y = _ncdhw(_golden("conv3d_tran_05_y"))
    w1 = _t(_kvcrs(_golden("conv3d_tran_05_w1")))
    w2 = _t(_kvcrs(_golden("conv3d_tran_05_w2")))
    x1 = ops.conv3d_transpose(_t(y), w1, out_spatial=(8, 9, 9))
    x2 = ops.conv3d_transpose(x1, w2, out_spatial=(16, 17, 17))
    np.testing.assert_allclose(x2.numpy(), _ndchw(_golden("conv3d_tran_05_x")),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("out_dhw", [(16, 9, 11), (15, 10, 12), (96, 5, 7)],
                         ids=str)
def test_conv3d_transpose_matches_jax(out_dhw):
    rs = np.random.RandomState(2)
    in_dhw = tuple(-(-d // 2) for d in out_dhw)
    y = rs.randn(1, *in_dhw, 6).astype(np.float32)
    w = (rs.randn(3, 3, 3, 4, 6) * 0.3).astype(np.float32)  # I = 4 outputs
    b = rs.randn(4).astype(np.float32)
    want = np.asarray(jops.conv3d_transpose(y, w, b, out_spatial=out_dhw))
    got = ops.conv3d_transpose(_t(y), _t(w), _t(b), out_spatial=out_dhw)
    assert tuple(got.shape) == want.shape
    # full fp32 on both sides: summation order only
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


# --------------------------------------------------------- soft-argmin


@pytest.mark.parametrize("case", ["01", "02"])
def test_softargmin_golden(case):
    x = _ndchw(_golden(f"softargmax_{case}_x"))
    want = np.transpose(_golden(f"softargmax_{case}_y"), (0, 2, 3, 1))
    got = ops.softargmin(_t(x), axis=1)
    # the JAX package's gate for these fixtures (tests/test_ops_golden.py)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jops.softargmin(x, axis=1)), atol=1e-6)


# ------------------------------------------------------------- models


def _specs(name, hw, max_disp=8):
    return (dataclasses.replace(STEREO_SPECS[name], input_hw=hw,
                                max_disp=max_disp),
            dataclasses.replace(JSPECS[name], input_hw=hw,
                                max_disp=max_disp))


def _jax_forward(jspec, params, left, right, lowering, dtype=jnp.float32):
    jp = jax.tree.map(lambda a: jnp.asarray(a, dtype), params)

    def run():
        return np.asarray(jstereo.stereo_forward(
            jspec, jp, jnp.asarray(left, dtype), jnp.asarray(right, dtype)),
            np.float32)
    if lowering == "plain":
        with jplain_lowering():
            return run()
    return run()


def _port_forward(spec, params, left, right, lowering, **kw):
    def run():
        return stereo_forward(spec, params, _t(left), _t(right), **kw)
    if lowering == "plain":
        with plain_lowering():
            return run()
    return run()


@pytest.mark.parametrize("lowering", LOWERINGS)
@pytest.mark.parametrize("s2d", [False, True], ids=["raw", "s2d"])
@pytest.mark.parametrize("hw", [(65, 129), (64, 128)], ids=str)
@pytest.mark.parametrize("name", MODELS_3D)
def test_forward_matches_jax_fp32(name, hw, s2d, lowering):
    spec, jspec = _specs(name, hw)
    params = conditioned(init_stereo_params(spec, seed=0))
    left, right = _inputs(hw, s2d)
    want = _jax_forward(jspec, params, left, right, lowering)
    got = _port_forward(spec, params, left, right, lowering)
    assert tuple(got.shape) == (1, *hw) and got.dtype == torch.float32
    # full fp32 on both sides (JAX at HIGHEST): conv summation order only,
    # through ~20 2D and 3D layers and the soft-argmin, in pixels
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)
    assert 0 <= got.min() and got.max() <= spec.full_max_disp


def test_forward_bf16_close_to_jax_fp32():
    hw = (65, 129)
    spec, jspec = _specs("nvsmall", hw)
    params = conditioned(init_stereo_params(spec, seed=0))
    left, right = _inputs(hw, s2d=True)
    want = _jax_forward(jspec, params, left, right, "fused")
    net = params_from_numpy(spec, params, device="cpu", dtype=torch.bfloat16)
    got = net(_t(left), _t(right))
    assert got.dtype == torch.bfloat16
    # bf16 activations and weights through the whole net, in pixels of a
    # 0..16 px range (JAX's own bf16 path is as far off its fp32 here)
    assert np.abs(got.float().numpy() - want).mean() < 0.05


def test_lowerings_agree():
    """Fused and plain are the same function (fp32 order only)."""
    spec, _ = _specs("nvtiny", (64, 128))
    net = params_from_numpy(spec, conditioned(init_stereo_params(spec)),
                            device="cpu")
    left, right = (_t(a) for a in _inputs((64, 128), s2d=False))
    assert not use_plain_lowering()
    fused = net(left, right)
    with plain_lowering():
        assert use_plain_lowering()
        plain = net(left, right)
    assert not use_plain_lowering()
    np.testing.assert_allclose(fused.numpy(), plain.numpy(), atol=1e-4)


@pytest.mark.slow
def test_nvsmall_matches_jax_full_resolution():
    hw = (321, 1025)
    spec, jspec = _specs("nvsmall", hw, max_disp=48)
    params = conditioned(init_stereo_params(spec, seed=0))
    left, right = _inputs(hw, s2d=True)
    want = _jax_forward(jspec, params, left, right, "fused")
    got = _port_forward(spec, params, left, right, "fused")
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)


# ------------------------------------------------------------- weights


@pytest.mark.parametrize("name", MODELS_3D)
def test_params_round_trip(name):
    spec = STEREO_SPECS[name]
    params = conditioned(init_stereo_params(spec, seed=5))
    back = params_to_numpy(params_from_numpy(spec, params, device="cpu"))
    jax.tree.map(np.testing.assert_array_equal, back, params)


@pytest.mark.parametrize("name", ["nvsmall", "resnet18"])
def test_golden_bundle_loads_into_the_model(name):
    """The repo's real weights (`tests/data/<name>_golden.npz`, 'disp'
    skipped) load with the spec's shapes and carry across exactly."""
    tree = params_from_npz(Path(__file__).parent / "data" /
                           f"{name}_golden.npz")
    net = params_from_numpy(STEREO_SPECS[name], tree, device="cpu")
    assert isinstance(net, StereoNet)
    jax.tree.map(np.testing.assert_array_equal, params_to_numpy(net), tree)


def test_full_max_disp_matches_jax():
    for name in MODELS_3D:
        assert STEREO_SPECS[name].full_max_disp == \
            JSPECS[name].full_max_disp == 2 * STEREO_SPECS[name].max_disp
