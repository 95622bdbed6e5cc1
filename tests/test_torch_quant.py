"""The port's quantization and its round-once convs against the JAX
package's, on the CPU: calibration (thresholds, the collector, the stereo
hooks), the exact int8 conv on both of its routes, the w8 and int8 stereo
rungs (calibration and forward: `tests/test_torch_quant_stereo.py`; the
node and the app: `tests/test_torch_quant_serving.py`), the Caffe int8
path and the calibration cache; and the bf16 stereo convs, which now round
once as JAX's do. Inputs are seeded numpy arrays fed to both
packages; each tolerance is stated with its reason."""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from redtail_tpu.io import caffe as jcaffe
from redtail_tpu.models import STEREO_SPECS as JSPECS
from redtail_tpu.models.caffe_net import CaffeNet as JCaffeNet
from redtail_tpu.ops import convolution as jconv
from redtail_tpu.quant import ptq as jptq

from redtail_tpu_torch.io import parse_prototxt
from redtail_tpu_torch.models import (STEREO_SPECS, CaffeNet,
                                      init_stereo_params)
from redtail_tpu_torch.ops import convolution as conv
from redtail_tpu_torch.quant import ptq, stereo_int8
from test_torch_stereo import conditioned

HW, MAX_DISP = (33, 65), 8


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """A few intra-op threads, so that parallel test workers do not
    oversubscribe the cores (restored after)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, 2))
    yield
    torch.set_num_threads(saved)


def _specs(name, hw=HW):
    return (dataclasses.replace(STEREO_SPECS[name], input_hw=hw,
                                max_disp=MAX_DISP),
            dataclasses.replace(JSPECS[name], input_hw=hw, max_disp=MAX_DISP))


def _frames(count, hw=HW, seed=1):
    rs = np.random.RandomState(seed)
    return [(rs.rand(*hw, 3).astype(np.float32),
             rs.rand(*hw, 3).astype(np.float32)) for _ in range(count)]


def _tree_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], dict):
            _tree_equal(a[k], b[k])
        else:
            np.testing.assert_array_equal(np.asarray(a[k]),
                                          np.asarray(b[k]), err_msg=k)


def _jax_tree(tree, dtype=jnp.float32):
    """A numpy tree for JAX's forward: float leaves in ``dtype``; int8
    weights and fp32 scales as they are (as its node's `cast_tree`)."""
    return jax.tree_util.tree_map_with_path(
        lambda p, a: jnp.asarray(a) if p[-1].key in (
            "weights_q", "w_scale", "x_scale") else jnp.asarray(a, dtype),
        tree)


# ----------------------------------------------------------- calibration


def test_thresholds_match_jax():
    rs = np.random.RandomState(0)
    data = np.concatenate([rs.randn(100_000), [500.0, -400.0]])
    assert ptq.entropy_threshold(data) == jptq.entropy_threshold(data)
    for pct in (100.0, 99.99, 50.0):
        assert ptq.amax_threshold(data, pct) == \
            jptq.amax_threshold(data, pct)
    for empty in (np.zeros(100), np.zeros(0)):
        assert ptq.entropy_threshold(empty) == jptq.entropy_threshold(empty)
        assert ptq.amax_threshold(empty) == jptq.amax_threshold(empty)


@pytest.mark.parametrize("method", ["entropy", "percentile", "max"])
def test_collector_scales_match_jax(method):
    rs = np.random.RandomState(1)
    port = ptq.CalibrationCollector(method=method)
    ref = jptq.CalibrationCollector(method=method)
    for i in range(3):
        # one sample above 65536 elements: both subsample it alike
        x = (rs.randn(1, 20, 70 * (i + 1), 32) * (i + 1)).astype(np.float32)
        for c in (port, ref):
            c.observe("a", x)
            c.observe("b", x[..., :3] ** 2)
    assert port.scales() == ref.scales()
    with pytest.raises(ValueError, match="calibration method"):
        ptq.CalibrationCollector(method="kl")


def test_nchw_flattening_would_sample_other_values():
    """Why the hooks permute to NHWC before subsampling: on a
    channels-last NCHW activation a plain flattening walks NCHW order and
    takes other elements."""
    x = torch.randn(1, 32, 40, 2100).contiguous(
        memory_format=torch.channels_last)
    nhwc = stereo_int8._nhwc_sample(x)
    flat = x.abs().reshape(-1)
    plain = flat[::max(1, flat.numel() // 65536)][:65536].numpy()
    assert nhwc.shape == plain.shape and not np.array_equal(nhwc, plain)
    np.testing.assert_array_equal(
        nhwc, np.abs(x.permute(0, 2, 3, 1).numpy()).reshape(-1)[
            ::x.numel() // 65536][:65536])


# ------------------------------------------------------------- execution


@pytest.mark.parametrize("c_in", [32, 256], ids=["K=288", "K=2304"])
@pytest.mark.parametrize("strides", [(1, 1), (2, 2)])
@pytest.mark.parametrize("padding", ["SAME", ((2, 0), (1, 1))],
                         ids=["same", "explicit"])
def test_conv2d_int8_bit_equal_to_jax(c_in, strides, padding):
    """K = 3 * 3 * 32 = 288 takes the fp32-carrier route, K = 2304 (above
    the 2**24 bound) im2col and `torch._int_mm`: both exact, so bit-equal
    to JAX's int32 conv after the same dequant."""
    rs = np.random.RandomState(c_in)
    x = rs.randint(-127, 128, (2, 9, 11, c_in)).astype(np.int8)
    x[0, 0, 0] = 127  # the extreme products
    w = rs.randint(-127, 128, (3, 3, c_in, 24)).astype(np.int8)
    w[..., 0] = 127
    xs = np.float32(0.0123)
    ws = ((rs.rand(24) + 0.5) * 1e-3).astype(np.float32)
    b = rs.randn(24).astype(np.float32)
    assert (9 * c_in > ptq.EXACT_FP32_K) == (c_in == 256)
    for out_dtype, jdt in ((torch.float32, jnp.float32),
                           (torch.bfloat16, jnp.bfloat16)):
        want = np.asarray(jptq.conv2d_int8(
            jnp.asarray(x), jnp.asarray(w), x_scale=xs,
            w_scale=jnp.asarray(ws), bias=jnp.asarray(b), strides=strides,
            padding=padding, out_dtype=jdt), np.float32)
        got = ptq.conv2d_int8(torch.from_numpy(x), torch.from_numpy(w),
                              x_scale=xs, w_scale=ws, bias=b,
                              strides=strides, padding=padding,
                              out_dtype=out_dtype)
        assert got.dtype == out_dtype
        np.testing.assert_array_equal(got.float().numpy(), want)


def test_conv2d_int8_sums_are_integers_past_the_bound():
    """The accumulator itself, route by route, against numpy's int64 sum:
    exact on both sides of K * 127**2 = 2**24."""
    rs = np.random.RandomState(3)
    for c_in in (ptq.EXACT_FP32_K // 9, ptq.EXACT_FP32_K // 9 + 1):
        x = np.full((1, c_in, 3, 3), 127, np.int8)
        w = np.full((2, c_in, 3, 3), 127, np.int8)
        w[1] = rs.randint(-127, 128, w[1].shape)
        got = ptq.conv2d_int8_acc(torch.from_numpy(x), torch.from_numpy(w),
                                  padding="VALID").numpy().reshape(-1)
        want = np.einsum("cij,ocij->o", x[0].astype(np.int64),
                         w.astype(np.int64))
        np.testing.assert_array_equal(got, want.astype(np.float32))
    with pytest.raises(TypeError, match="int8"):
        ptq.conv2d_int8_acc(torch.zeros(1, 1, 3, 3),
                            torch.zeros(1, 1, 3, 3, dtype=torch.int8))


def test_quantize_act_matches_jax_with_ties():
    """Round half to even on both sides, exact .5 ties included (scale
    0.5: x / scale lands on k + 0.5), and the clip at +-127."""
    rs = np.random.RandomState(4)
    x = (rs.randn(2, 7, 9, 5) * 40).astype(np.float32)
    x.reshape(-1)[:8] = np.array([0.25, 0.75, 1.25, -0.25, -1.25, 500.0,
                                  -500.0, 63.25], np.float32)
    for scale in (0.5, np.float32(0.0371), 1.7):
        want = np.asarray(jptq.quantize_act(jnp.asarray(x), scale))
        got = ptq.quantize_act(torch.from_numpy(x), scale)
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), want)
    got = ptq.quantize_act(torch.from_numpy(x), 0.5).numpy().reshape(-1)
    np.testing.assert_array_equal(got[:8], [0, 2, 2, 0, -2, 127, -127, 126])
    xb = torch.from_numpy(x).to(torch.bfloat16)
    np.testing.assert_array_equal(
        ptq.quantize_act(xb, 0.1).numpy(),
        np.asarray(jptq.quantize_act(jnp.asarray(xb.float().numpy(),
                                                 jnp.bfloat16), 0.1)))


def test_conv2d_w8_matches_jax():
    rs = np.random.RandomState(5)
    x = rs.randn(1, 12, 14, 8).astype(np.float32)
    w = rs.randn(3, 3, 8, 16).astype(np.float32)
    b = rs.randn(16).astype(np.float32)
    wq, wsc = ptq.quantize_per_channel(w)
    jq, jsc = jptq.quantize_per_channel(w)
    np.testing.assert_array_equal(wq, jq)
    np.testing.assert_array_equal(wsc, jsc)
    want = np.asarray(jptq.conv2d_w8(jnp.asarray(x), jnp.asarray(wq),
                                     jnp.asarray(wsc), jnp.asarray(b)))
    got = ptq.conv2d_w8(torch.from_numpy(x), torch.from_numpy(wq),
                        torch.from_numpy(wsc), torch.from_numpy(b))
    # fp32 on both sides: conv summation order
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_w8_tree_and_dequantize_match_jax(dtype):
    spec, _ = _specs("resnet18_2d")
    params = conditioned(init_stereo_params(spec, seed=2))
    q = ptq.quantize_stereo_params_w8(params)
    _tree_equal(q, jax.tree.map(np.asarray,
                                jptq.quantize_stereo_params_w8(params)))
    jdt = None if dtype is None else jnp.bfloat16
    want = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        jptq.dequantize_tree(
                            jptq.quantize_stereo_params_w8(params), jdt))
    _tree_equal(ptq.dequantize_tree(q, dtype), want)


# -------------------------------------------------------- Caffe int8 path

CAFFE_INT8 = """
input: "data"
input_shape { dim: 1 dim: 3 dim: 12 dim: 14 }
layer { name: "c1" type: "Convolution" bottom: "data" top: "c1"
        convolution_param { num_output: 128 kernel_size: 3 pad: 1 } }
layer { name: "r1" type: "ReLU" bottom: "c1" top: "c1" }
layer { name: "c2" type: "Convolution" bottom: "c1" top: "c2"
        convolution_param { num_output: 16 kernel_size: 3 stride: 2
                            pad: 1 } }
layer { name: "p" type: "Pooling" bottom: "c2" top: "p"
        pooling_param { pool: MAX kernel_size: 2 stride: 2 } }
layer { name: "fc" type: "InnerProduct" bottom: "p" top: "fc"
        inner_product_param { num_output: 6 } }
layer { name: "out" type: "Softmax" bottom: "fc" top: "out" }
"""


def test_caffe_net_int8_matches_jax():
    """c1 (K = 27) takes the fp32-carrier route and c2 (K = 1152) the
    `_int_mm` one. Calibration scales within rtol 1e-4 (fp32 blobs);
    with JAX's scales fed to both, c1's int8 output is bit-equal (its
    input is the frame itself) and the rest within 1e-3 of each blob's
    largest magnitude (a c1 value within fp32 noise of a rounding
    boundary of c2's input may take the other step)."""
    jnet = JCaffeNet(jcaffe.parse_prototxt(CAFFE_INT8), seed=0)
    net = CaffeNet(parse_prototxt(CAFFE_INT8), seed=0, device="cpu")
    rs = np.random.RandomState(7)
    frames = [rs.randint(0, 256, (12, 14, 3)).astype(np.float32)
              for _ in range(3)]
    want = jptq.calibrate_caffe_net(jnet, frames[:2], method="max")
    got = ptq.calibrate_caffe_net(net, frames[:2], method="max")
    assert set(got) == set(want) == {"c1", "c2", "fc"}
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-4)
    jblobs = jptq.caffe_net_forward_int8(jnet, frames[2], want,
                                         return_blobs=True)
    blobs = ptq.caffe_net_forward_int8(net, frames[2], want,
                                       return_blobs=True)
    np.testing.assert_array_equal(
        blobs["c1"].permute(0, 2, 3, 1).numpy(), np.asarray(jblobs["c1"]))
    for name in ("c2", "p", "fc", "out"):
        w = np.asarray(jblobs[name])
        g = blobs[name].numpy()
        g = g.transpose(0, 2, 3, 1) if g.ndim == 4 else g
        np.testing.assert_allclose(g, w, atol=1e-3 * np.abs(w).max(),
                                   err_msg=name)
    out = ptq.caffe_net_forward_int8(net, frames[2], want)
    assert out.shape == (1, 6)


def test_calibration_cache_round_trip(tmp_path):
    net = CaffeNet(parse_prototxt(CAFFE_INT8), seed=0, device="cpu")
    frames = [np.random.RandomState(8).randint(0, 256, (12, 14, 3)).astype(
        np.float32)]
    cache = tmp_path / "calib.json"
    scales = ptq.calibrate_or_load(net, frames, cache, method="percentile")
    assert cache.exists()
    assert ptq.load_calibration(cache) == scales
    assert jptq.load_calibration(cache) == scales  # one format
    jptq.save_calibration(scales, tmp_path / "jax.json")
    assert (tmp_path / "jax.json").read_text() == cache.read_text()
    # a cache present is read, not recomputed
    assert ptq.calibrate_or_load(net, [], cache) == scales


# ------------------------------------------------------ round-once convs


def _ordered(a: np.ndarray) -> np.ndarray:
    """bf16 bit patterns as integers in the order of their values, so one
    ulp apart is 1 apart (zeros of both signs at 0)."""
    bits = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16).view(torch.int16).numpy().astype(np.int32)
    return np.where(bits < 0, -(bits & 0x7FFF), bits)


def _old_route(x, w, b, op, **kw):
    """The conv as the port ran it before the repair: cuDNN's (here
    PyTorch's) bf16 conv, its rounded bf16 sum widened, the bias added in
    fp32, and rounded again."""
    out = op(x, w, **kw)
    return (out.float() + b.float().reshape(-1, *[1] * (out.dim() - 2))
            ).to(torch.bfloat16)


CONV_CASES = ("conv2d", "conv3d", "conv2d_transpose", "conv3d_transpose")


@pytest.mark.parametrize("case", CONV_CASES)
def test_bf16_convs_round_once_as_jax(case):
    """Seeded bf16 convs against JAX's `conv2d` / `conv3d` and transposes
    (fp32 sum, bias, one rounding): the port within 1 bf16 ulp (summation
    order can flip a rounding), and with fewer mismatching
    elements than the route that rounded twice."""
    rs = np.random.RandomState(CONV_CASES.index(case))
    nd = 3 if "3d" in case else 2
    spatial = (6, 9, 11)[-nd:]
    c_in, c_out = 16, 8
    x = rs.randn(2, *spatial, c_in).astype(np.float32)
    w = (rs.randn(*(3,) * nd, c_in, c_out) / 8).astype(np.float32)
    if "transpose" in case:
        w = np.swapaxes(w, -1, -2).copy()  # I = the transpose's output
    b = (rs.randn(c_out) * 3).astype(np.float32)
    xj, wj, bj = (jnp.asarray(a, jnp.bfloat16) for a in (x, w, b))
    xt, wt, bt = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, w, b))
    if "transpose" in case:
        out_spatial = tuple(2 * s for s in spatial)
        strides = (2,) * nd
        jfn = jconv.conv3d_transpose if nd == 3 else jconv.conv2d_transpose
        tfn = conv.conv3d_transpose if nd == 3 else conv.conv2d_transpose
        want = jfn(xj, wj, bj, out_spatial=out_spatial, strides=strides)
        got = tfn(xt, wt, bt, out_spatial=out_spatial, strides=strides)
        old_op, perm_w = ((F.conv_transpose3d, (4, 3, 0, 1, 2)) if nd == 3
                          else (F.conv_transpose2d, (3, 2, 0, 1)))
        full = old_op(xt.movedim(-1, 1), wt.permute(*perm_w), stride=2)
        crop = tuple(slice(0, s) for s in out_spatial)  # lo pad 0 here
        old = (full[(slice(None), slice(None), *crop)].float()
               + bt.float().reshape(-1, *[1] * nd)).to(torch.bfloat16)
    else:
        jfn = jconv.conv3d if nd == 3 else jconv.conv2d
        tfn = conv.conv3d if nd == 3 else conv.conv2d
        want = jfn(xj, wj, bj)
        got = tfn(xt, wt, bt)
        old_op, perm_w = ((F.conv3d, (4, 3, 0, 1, 2)) if nd == 3
                          else (F.conv2d, (3, 2, 0, 1)))
        old = _old_route(xt.movedim(-1, 1), wt.permute(*perm_w), bt, old_op,
                         padding=1)
    want = np.asarray(want, np.float32)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    old = old.movedim(1, -1).float().numpy()
    assert want.shape == got.shape == old.shape
    ulps = np.abs(_ordered(got) - _ordered(want))
    # one ulp, or where cancellation leaves a sum near zero the fp32 sums'
    # order error (1e-4 at these O(1) sums), as the port's bf16 gates allow
    near = np.abs(got - want) <= 1e-4
    assert (ulps <= 1)[~near].all(), f"{ulps[~near].max()} ulps"
    new_off = int((got != want).sum())
    old_off = int((old != want).sum())
    assert new_off < old_off, (new_off, old_off)


@pytest.mark.parametrize("threads", [2, 4])
def test_tf32_switches_hold_on_node_threads(threads):
    """The TF32 and determinism switches are process-wide and the serving
    nodes run on threads of their own, one bf16 (TF32 allowed) beside fp32
    ones (TF32 off): inside `_tf32` each thread sees its own setting for
    as long as its launch takes (here a sleep that drops the GIL, as a
    CUDA conv's launch does), and the process's settings are back where
    they were after. The stand-in for a CUDA tensor only says it is one."""
    import threading
    import time
    import types

    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)
    seen, start = [], threading.Barrier(threads)

    def node(allow):
        on_card = types.SimpleNamespace(is_cuda=True)
        start.wait()
        for _ in range(50):
            with conv._tf32(on_card, allow):
                time.sleep(2e-4)
                seen.append((torch.backends.cudnn.allow_tf32,
                             torch.backends.cuda.matmul.allow_tf32,
                             torch.backends.cudnn.deterministic)
                            == (allow, allow, True))

    workers = [threading.Thread(target=node, args=(k % 2 == 0,))
               for k in range(threads)]
    for t in workers:
        t.start()
    for t in workers:
        t.join()
    assert len(seen) == 50 * threads and all(seen), seen.count(False)
    assert (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.deterministic) == saved
