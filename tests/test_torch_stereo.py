"""The port's ResNet18-2D slice against the JAX package's, on the CPU.

Weights come from the port's seeded numpy init and are fed to both
packages; biases are randomized (zero biases hide boundary-row bugs). The
residual-branch and feature-head weights are scaled by 0.3 so the cost
volume is O(1), as a trained network's is: under plain He-init it reaches
~1e4, and the soft-argmax then turns fp32 summation-order noise into
~5e-4 of output (and JAX's own bf16 path into a mean error of 0.02).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from redtail_tpu.models import STEREO_SPECS as JSPECS
from redtail_tpu.models import stereo as jstereo
from redtail_tpu.ops.space_to_depth import space_to_depth2_np

from redtail_tpu_torch.models import (
    STEREO_SPECS,
    init_stereo_params,
    params_from_numpy,
    params_to_numpy,
    stereo_forward,
)
from redtail_tpu_torch.models.stereo import _spec_layer_shapes


def conditioned(params, seed=7):
    rs = np.random.RandomState(seed)

    def walk(node, path):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v, f"{path}/{k}")
            elif k == "biases":
                out[k] = (rs.randn(*v.shape) * 0.1).astype(np.float32)
            elif path.endswith(("res_conv2", "encoder2D_out")):
                out[k] = (v * 0.3).astype(np.float32)
            else:
                out[k] = v
        return out
    return walk(params, "")


def _specs(hw, max_disp):
    return (dataclasses.replace(STEREO_SPECS["resnet18_2d"], input_hw=hw,
                                max_disp=max_disp),
            dataclasses.replace(JSPECS["resnet18_2d"], input_hw=hw,
                                max_disp=max_disp))


def _inputs(hw, s2d, seed=2):
    rs = np.random.RandomState(seed)
    left, right = (rs.rand(1, *hw, 3).astype(np.float32) for _ in range(2))
    if s2d:
        left, right = space_to_depth2_np(left), space_to_depth2_np(right)
    return left, right


def _jax_forward(jspec, params, left, right, dtype=jnp.float32):
    jp = jax.tree.map(lambda a: jnp.asarray(a, dtype), params)
    return np.asarray(jstereo.stereo_forward(
        jspec, jp, jnp.asarray(left, dtype), jnp.asarray(right, dtype)),
        np.float32)


@pytest.mark.parametrize("name", sorted(STEREO_SPECS))
def test_specs_and_layer_shapes_match(name):
    assert dataclasses.asdict(STEREO_SPECS[name]) == dataclasses.asdict(
        JSPECS[name])
    assert _spec_layer_shapes(STEREO_SPECS[name]) == \
        jstereo._spec_layer_shapes(JSPECS[name])


@pytest.mark.parametrize("s2d", [False, True], ids=["raw", "s2d"])
@pytest.mark.parametrize("hw", [(65, 129), (64, 128)])
def test_forward_matches_jax_fp32(hw, s2d):
    spec, jspec = _specs(hw, 8)
    params = conditioned(init_stereo_params(spec, seed=0))
    left, right = _inputs(hw, s2d)
    want = _jax_forward(jspec, params, left, right)
    got = stereo_forward(spec, params, torch.from_numpy(left),
                         torch.from_numpy(right))
    assert tuple(got.shape) == (1, *hw) and got.dtype == torch.float32
    # full fp32 on both sides (JAX at HIGHEST); conv summation order only,
    # through 29 conv layers and the soft-argmax, in sigmoid units
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_forward_bf16_close_to_jax_fp32():
    hw = (65, 129)
    spec, jspec = _specs(hw, 8)
    params = conditioned(init_stereo_params(spec, seed=0))
    left, right = _inputs(hw, s2d=True)
    want = _jax_forward(jspec, params, left, right)
    net = params_from_numpy(spec, params, device="cpu", dtype=torch.bfloat16)
    got = net(torch.from_numpy(left), torch.from_numpy(right))
    assert got.dtype == torch.bfloat16
    # bf16 activations and weights through the whole net (JAX's own bf16
    # path is ~3e-3 off its fp32 here)
    assert np.abs(got.float().numpy() - want).mean() < 1e-2


@pytest.mark.slow
def test_forward_matches_jax_full_resolution():
    hw = (321, 1025)
    spec, jspec = _specs(hw, 48)
    params = conditioned(init_stereo_params(spec, seed=0))
    left, right = _inputs(hw, s2d=True)
    want = _jax_forward(jspec, params, left, right)
    got = stereo_forward(spec, params, torch.from_numpy(left),
                         torch.from_numpy(right))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_init_stereo_params():
    spec = STEREO_SPECS["resnet18_2d"]
    a, b = init_stereo_params(spec, seed=3), init_stereo_params(spec, seed=3)
    c = init_stereo_params(spec, seed=4)
    for path, kshape, bshape in _spec_layer_shapes(spec):
        leaf_a, leaf_b, leaf_c = a, b, c
        for p in path.split("/"):
            leaf_a, leaf_b, leaf_c = leaf_a[p], leaf_b[p], leaf_c[p]
        assert leaf_a["weights"].shape == kshape
        np.testing.assert_array_equal(leaf_a["weights"], leaf_b["weights"])
        assert not np.array_equal(leaf_a["weights"], leaf_c["weights"])
        np.testing.assert_array_equal(leaf_a["biases"], np.zeros(bshape))
        # He-init: std sqrt(2 / fan_in), as the JAX init
        fan_in = np.prod(kshape[:-1])
        assert abs(leaf_a["weights"].std() * np.sqrt(fan_in / 2) - 1) < 0.3


def test_params_round_trip():
    spec = STEREO_SPECS["resnet18_2d"]
    params = conditioned(init_stereo_params(spec, seed=5))
    back = params_to_numpy(params_from_numpy(spec, params, device="cpu"))
    jax.tree.map(np.testing.assert_array_equal, back, params)


def test_int8_leaves_not_ported():
    spec = STEREO_SPECS["resnet18_2d"]
    params = init_stereo_params(spec)
    params["bneck_encoder2D"]["conv2D_1"]["weights_q"] = np.zeros(1, np.int8)
    with pytest.raises(NotImplementedError, match="module queue item 7"):
        params_from_numpy(spec, params, device="cpu")


def test_s2d_input_must_match_spec_size():
    spec, _ = _specs((65, 129), 8)
    net = params_from_numpy(spec, init_stereo_params(spec), device="cpu")
    left, right = _inputs((64, 128), s2d=True)
    with pytest.raises(ValueError, match="does not match"):
        net(torch.from_numpy(left), torch.from_numpy(right))
    other, _ = _specs((64, 128), 8)
    with pytest.raises(ValueError, match="built for"):
        stereo_forward(other, net, torch.from_numpy(left),
                       torch.from_numpy(right))
