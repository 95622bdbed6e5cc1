"""The PyTorch port's operators against the JAX package's, on the CPU.

Inputs are seeded numpy arrays fed to both packages; each tolerance is
stated with its reason.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from redtail_tpu import ops as jops
from redtail_tpu.io import golden as jgolden
from redtail_tpu.ops import space_to_depth as js2d
from redtail_tpu.runtime.profiler import StageProfiler as JStageProfiler

from redtail_tpu_torch import ops
from redtail_tpu_torch.io import golden
from redtail_tpu_torch.ops import space_to_depth as s2d
from redtail_tpu_torch.runtime.profiler import StageProfiler


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        t, np.float32)


@pytest.mark.parametrize("in_dim,k,s", [(321, 5, 2), (320, 5, 2),
                                        (161, 3, 2), (160, 3, 2),
                                        (33, 3, 1), (1, 3, 2)])
def test_tf_same_padding(in_dim, k, s):
    assert ops.tf_same_padding(in_dim, k, s) == jops.tf_same_padding(
        in_dim, k, s)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("hw", [(13, 17), (12, 16)])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_conv2d(stride, hw, dtype):
    rs = np.random.RandomState(0)
    x = rs.randn(2, *hw, 5).astype(np.float32)
    w = (rs.randn(3, 3, 5, 7) * 0.3).astype(np.float32)
    b = rs.randn(7).astype(np.float32)
    want = np.asarray(jops.conv2d(x, w, b, strides=(stride, stride)))
    if dtype == "fp32":
        got = ops.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                         torch.from_numpy(b), strides=(stride, stride))
        # both full fp32 (JAX at HIGHEST); only the summation order differs
        np.testing.assert_allclose(_np(got), want, atol=1e-5)
    else:
        t = lambda a: torch.from_numpy(a).bfloat16()  # noqa: E731
        j = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
        got = ops.conv2d(t(x), t(w), t(b), strides=(stride, stride))
        want = np.asarray(jops.conv2d(j(x), j(w), j(b),
                                      strides=(stride, stride)), np.float32)
        assert got.dtype == torch.bfloat16
        # Same bf16 operands and fp32 accumulation on both sides; the port
        # rounds the conv output to bf16 before the fp32 bias add (cuDNN
        # emits bf16), JAX only after it. rtol 2e-2 covers that rounding;
        # where the bias cancels the conv the result is near zero, so the
        # atol is one bf16 ulp at the output's largest magnitude.
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        np.testing.assert_allclose(_np(got), want, rtol=2e-2, atol=ulp)


@pytest.mark.parametrize("out_hw", [(13, 17), (12, 16), (321, 9)])
def test_conv2d_transpose(out_hw):
    rs = np.random.RandomState(1)
    in_hw = tuple(-(-d // 2) for d in out_hw)
    y = rs.randn(1, *in_hw, 6).astype(np.float32)
    w = (rs.randn(3, 3, 4, 6) * 0.3).astype(np.float32)  # I = 4 outputs
    b = rs.randn(4).astype(np.float32)
    want = np.asarray(jops.conv2d_transpose(y, w, b, out_spatial=out_hw))
    got = ops.conv2d_transpose(torch.from_numpy(y), torch.from_numpy(w),
                               torch.from_numpy(b), out_spatial=out_hw)
    assert tuple(got.shape) == want.shape
    # full fp32 on both sides: summation order only
    np.testing.assert_allclose(_np(got), want, atol=1e-5)


@pytest.mark.parametrize("hw", [(7, 9), (8, 10), (7, 10), (8, 9)])
def test_space_to_depth2_np(hw):
    x = np.random.RandomState(2).randint(0, 256, (2, *hw, 3)).astype(np.uint8)
    got = s2d.space_to_depth2_np(x)
    np.testing.assert_array_equal(got, js2d.space_to_depth2_np(x))
    assert got.shape[1:3] == s2d.s2d_hw(hw) == js2d.s2d_hw(hw)


@pytest.mark.parametrize("hw", [(321, 1025), (320, 1024), (65, 128),
                                (64, 129)])
def test_conv5s2_kernel_to_s2d(hw):
    w5 = np.random.RandomState(3).randn(5, 5, 3, 8).astype(np.float32)
    got = s2d.conv5s2_kernel_to_s2d(w5, hw)
    np.testing.assert_array_equal(
        got, np.asarray(js2d.conv5s2_kernel_to_s2d(w5, hw)))


@pytest.mark.parametrize("hw", [(13, 17), (12, 16)])
def test_s2d_stem_equals_strided_stem(hw):
    """The remapped 3x3 stem over packed input equals the 5x5 stride-2 stem
    (the algebra the model's s2d path rests on), both parities."""
    rs = np.random.RandomState(4)
    x = rs.rand(1, *hw, 3).astype(np.float32)
    w5 = rs.randn(5, 5, 3, 8).astype(np.float32)
    raw = ops.conv2d(torch.from_numpy(x), torch.from_numpy(w5),
                     strides=(2, 2))
    packed = ops.conv2d(torch.from_numpy(s2d.space_to_depth2_np(x)),
                        torch.from_numpy(s2d.conv5s2_kernel_to_s2d(w5, hw)))
    # same products, reassociated (12x3x3 vs 3x5x5): fp32 order only
    np.testing.assert_allclose(_np(packed), _np(raw), atol=1e-5)


def test_elu_sigmoid():
    x = np.random.RandomState(5).randn(3, 7, 11).astype(np.float32) * 3
    # both fp32 elementwise with libm-class transcendentals
    np.testing.assert_allclose(_np(ops.elu(torch.from_numpy(x))),
                               np.asarray(jops.elu(x)), atol=1e-6)
    np.testing.assert_allclose(_np(ops.sigmoid(torch.from_numpy(x))),
                               np.asarray(jops.sigmoid(x)), atol=1e-6)


@pytest.mark.parametrize("axis", [-1, 1])
@pytest.mark.parametrize("fn", ["softargmax", "softargmin"])
def test_softargmax(axis, fn):
    x = np.random.RandomState(6).randn(2, 9, 5, 7).astype(np.float32) * 2
    got = getattr(ops, fn)(torch.from_numpy(x), axis=axis)
    want = np.asarray(getattr(jops, fn)(x, axis=axis))
    # fp32 softmax + weighted sum: rounding of exp and the sum only
    np.testing.assert_allclose(_np(got), want, atol=1e-6)


def test_softargmax_bf16_casts_back():
    x = np.random.RandomState(7).randn(2, 5, 8).astype(np.float32)
    got = ops.softargmax(torch.from_numpy(x).bfloat16(), axis=-1)
    want = np.asarray(jops.softargmax(jnp.asarray(x, jnp.bfloat16), axis=-1))
    assert got.dtype == torch.bfloat16
    # the fp32 result is rounded to bf16 once on each side
    np.testing.assert_allclose(_np(got), want.astype(np.float32), atol=1e-6)


def test_preprocess_stereo_host():
    pytest.importorskip("cv2")
    from redtail_tpu.ops.preprocess import preprocess_stereo_host as jprep

    from redtail_tpu_torch.ops.preprocess import preprocess_stereo_host

    img = np.random.RandomState(8).randint(0, 256, (40, 70, 3)).astype(
        np.uint8)
    np.testing.assert_array_equal(preprocess_stereo_host(img, 33, 17),
                                  jprep(img, 33, 17))


def test_golden_bin_round_trip(tmp_path):
    x = np.random.RandomState(9).randn(2, 3, 4).astype(np.float32)
    golden.write_bin(x, tmp_path / "a.bin")
    jgolden.write_bin(x, tmp_path / "b.bin")
    assert (tmp_path / "a.bin").read_bytes() == (tmp_path / "b.bin").read_bytes()
    np.testing.assert_array_equal(golden.read_bin(tmp_path / "b.bin"), x)


def test_stage_profiler_matches_jax():
    port, ref = StageProfiler(), JStageProfiler()
    for p in (port, ref):
        for s in (0.001, 0.003, 0.002):
            p.record("a", s)
    assert port.stats() == ref.stats()
    assert port.report() == ref.report()
