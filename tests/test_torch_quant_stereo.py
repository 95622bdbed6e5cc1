"""The stereo int8 and w8 rungs against the JAX package's, on the CPU:
`calibrate_stereo` (forward pre-hooks against JAX's conv tap) and the
forward of `StereoNet` with int8 leaves and with the dequantized w8 tree,
for ResNet18-2D and NVTiny at reduced size. Inputs are seeded numpy arrays
fed to both packages; each tolerance is stated with its reason."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from redtail_tpu.models import stereo as jstereo
from redtail_tpu.quant import stereo_int8 as jint8

from redtail_tpu_torch.models import (init_stereo_params, params_from_numpy,
                                      params_to_numpy)
from redtail_tpu_torch.quant import ptq, stereo_int8
from test_torch_quant import _frames, _jax_tree, _specs, _tree_equal
from test_torch_stereo import conditioned

HW = (33, 65)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """A few intra-op threads, so that parallel test workers do not
    oversubscribe the cores (restored after)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, 2))
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def jax_calibrated():
    """Per model: (spec, JAX spec, weights, frames, JAX's scales), JAX's
    calibration run once for the module."""
    cache = {}

    def get(name):
        if name not in cache:
            spec, jspec = _specs(name)
            params = conditioned(init_stereo_params(spec, seed=0))
            frames = _frames(2)
            cache[name] = (spec, jspec, params, frames, jint8.calibrate_stereo(
                jspec, jax.tree.map(jnp.asarray, params), frames))
        return cache[name]
    return get


@pytest.mark.parametrize("name", ["resnet18_2d", "nvtiny"])
def test_calibrate_stereo_matches_jax(name, jax_calibrated):
    """The hooks see what JAX's tap sees (both towers, NHWC-order
    subsamples): fp32 on both sides, scales within rtol 1e-4 (a percentile
    of activations that differ in fp32 summation order only)."""
    spec, jspec, params, frames, want = jax_calibrated(name)
    got = stereo_int8.calibrate_stereo(spec, params, frames, device="cpu")
    assert set(got) == set(want) == set(
        stereo_int8.int8_layer_paths(params, spec))
    assert stereo_int8.int8_layer_paths(params, spec) == \
        jint8.int8_layer_paths(params, jspec)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=1e-4,
                                   err_msg=path)
    if spec.corr:  # the bottleneck stays in bf16 / fp32
        assert not any(p.startswith("bneck") for p in got)


# -------------------------------------------------------- stereo forward


@pytest.mark.parametrize("name", ["resnet18_2d", "nvtiny"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_int8_forward_matches_jax(name, dtype, jax_calibrated):
    """JAX's scales fed to both: the int8 leaves through each package's
    forward, raw frames. Gates: the port's existing ones (fp32: ResNet18-2D
    1e-4 sigmoid units, the 3D models 1e-3 px; bf16 against the same JAX
    path in bf16: means of 1e-2 sigmoid units and 0.1 px)."""
    spec, jspec, params, frames, scales = jax_calibrated(name)
    qtree = stereo_int8.quantize_stereo_params_int8(params, scales)
    _tree_equal(qtree, jax.tree.map(np.asarray,
                                    jint8.quantize_stereo_params_int8(
                                        params, scales)))
    tdt, jdt = ((torch.float32, jnp.float32) if dtype == "fp32"
                else (torch.bfloat16, jnp.bfloat16))
    left, right = (a[None] for a in frames[0])
    # eager, as JAX's own function runs op by op (its jitted form fuses
    # the quantize steps and can take the other step on a few inputs)
    want = np.asarray(jstereo.stereo_forward(
        jspec, _jax_tree(qtree, jdt), jnp.asarray(left, jdt),
        jnp.asarray(right, jdt)), np.float32)
    net = params_from_numpy(spec, qtree, device="cpu", dtype=tdt)
    got = net(torch.from_numpy(left).to(tdt),
              torch.from_numpy(right).to(tdt)).float().numpy()
    assert got.shape == (1, *HW)
    if dtype == "fp32":
        np.testing.assert_allclose(got, want,
                                   atol=1e-4 if spec.corr else 1e-3)
    else:
        assert np.abs(got - want).mean() < (1e-2 if spec.corr else 0.1)
    _tree_equal(params_to_numpy(params_from_numpy(spec, qtree,
                                                  device="cpu")), qtree)


def test_int8_stem_takes_only_raw_frames():
    from redtail_tpu_torch.ops.space_to_depth import space_to_depth2_np

    spec, _ = _specs("nvtiny")
    params = init_stereo_params(spec, seed=0)
    net = params_from_numpy(spec, stereo_int8.quantize_stereo_params_int8(
        params, {"encoder2D/conv1": 0.01}), device="cpu")
    assert net.conv1_s2d is None
    left = space_to_depth2_np(_frames(1)[0][0][None])
    with pytest.raises(ValueError, match="int8 conv1"):
        net(torch.from_numpy(left), torch.from_numpy(left))


@pytest.mark.parametrize("name", ["resnet18_2d", "nvtiny"])
def test_w8_forward_matches_jax(name):
    """The dequantized w8 tree (the node's w8 rung) in fp32 on both sides:
    the port's fp32 gates."""
    spec, jspec = _specs(name)
    params = conditioned(init_stereo_params(spec, seed=0))
    tree = ptq.dequantize_tree(ptq.quantize_stereo_params_w8(params))
    left, right = (a[None] for a in _frames(1)[0])
    want = np.asarray(jstereo.stereo_forward(
        jspec, jax.tree.map(jnp.asarray, tree), jnp.asarray(left),
        jnp.asarray(right)))
    got = params_from_numpy(spec, tree, device="cpu")(
        torch.from_numpy(left), torch.from_numpy(right)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4 if spec.corr else 1e-3)


