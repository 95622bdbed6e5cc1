"""The port's Caffe toolchain against the JAX package's, on the CPU: the
prototxt and caffemodel parsers, the `CaffeNet` interpreter layer by layer
and on a YOLO-shaped graph, the random-weight draws, and YOLO's
post-processing.

Inputs are seeded numpy arrays fed to both packages. The port's blobs are
NCHW (Caffe's layout) and JAX's NHWC; 4D blobs are compared after a
permute. Each tolerance is stated with its reason.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from redtail_tpu.io import caffe as jcaffe
from redtail_tpu.io import protolite as jprotolite
from redtail_tpu.models import yolo as jyolo
from redtail_tpu.models.caffe_net import CaffeNet as JCaffeNet
from redtail_tpu.models.trailnet import params_from_w8_npz as jparams_w8
from redtail_tpu.models.trailnet_proto import (
    emit_trailnet_prototxt as jemit_trailnet_prototxt,
)

from redtail_tpu_torch.io import (
    load_caffemodel,
    load_prototxt,
    parse_caffemodel,
    parse_prototxt,
    protolite,
    write_caffemodel,
)
from redtail_tpu_torch.io.caffe import Msg
from redtail_tpu_torch.models import (
    CaffeNet,
    emit_trailnet_prototxt,
    native_params_to_blobs,
    yolo,
)
from redtail_tpu_torch.models.trailnet import params_from_w8_npz

TRAILNET_W8 = Path(__file__).resolve().parent / "data" / \
    "trailnet_synth_trained.npz"


def yolo_standin_prototxt(widths=(8, 16, 16, 8)) -> str:
    """A YOLO-shaped graph, not the YOLO model: a 448x448 BGR frame, /255
    in a Scale layer, four Convolution / leaky-ReLU / Pooling stages down
    to 7x7, Dropout, and an InnerProduct to the (1470,) YOLOv1 head."""
    c1, c2, c3, c4 = widths
    return f"""
input: "data"
input_shape {{ dim: 1 dim: 3 dim: 448 dim: 448 }}
layer {{ name: "scale" type: "Scale" bottom: "data" top: "scaled"
        scale_param {{ filler {{ value: 0.00392156862745098 }} }} }}
layer {{ name: "conv1" type: "Convolution" bottom: "scaled" top: "conv1"
        convolution_param {{ num_output: {c1} kernel_size: 7 stride: 2
                             pad: 3 }} }}
layer {{ name: "relu1" type: "ReLU" bottom: "conv1" top: "conv1"
        relu_param {{ negative_slope: 0.1 }} }}
layer {{ name: "pool1" type: "Pooling" bottom: "conv1" top: "pool1"
        pooling_param {{ pool: MAX kernel_size: 2 stride: 2 }} }}
layer {{ name: "conv2" type: "Convolution" bottom: "pool1" top: "conv2"
        convolution_param {{ num_output: {c2} kernel_size: 3 pad: 1 }} }}
layer {{ name: "relu2" type: "ReLU" bottom: "conv2" top: "conv2"
        relu_param {{ negative_slope: 0.1 }} }}
layer {{ name: "pool2" type: "Pooling" bottom: "conv2" top: "pool2"
        pooling_param {{ pool: MAX kernel_size: 2 stride: 2 }} }}
layer {{ name: "conv3" type: "Convolution" bottom: "pool2" top: "conv3"
        convolution_param {{ num_output: {c3} kernel_size: 3 stride: 2
                             pad: 1 }} }}
layer {{ name: "relu3" type: "ReLU" bottom: "conv3" top: "conv3"
        relu_param {{ negative_slope: 0.1 }} }}
layer {{ name: "pool3" type: "Pooling" bottom: "conv3" top: "pool3"
        pooling_param {{ pool: MAX kernel_size: 2 stride: 2 }} }}
layer {{ name: "conv4" type: "Convolution" bottom: "pool3" top: "conv4"
        convolution_param {{ num_output: {c4} kernel_size: 1 }} }}
layer {{ name: "relu4" type: "ReLU" bottom: "conv4" top: "conv4"
        relu_param {{ negative_slope: 0.1 }} }}
layer {{ name: "pool4" type: "Pooling" bottom: "conv4" top: "pool4"
        pooling_param {{ pool: AVE kernel_size: 2 stride: 2 }} }}
layer {{ name: "drop" type: "Dropout" bottom: "pool4" top: "pool4"
        dropout_param {{ dropout_ratio: 0.5 }} }}
layer {{ name: "fc" type: "InnerProduct" bottom: "pool4" top: "result"
        inner_product_param {{ num_output: 1470 }} }}
"""


def _tree(node):
    """A parsed message as plain nested data, for either package's Msg."""
    if hasattr(node, "fields"):
        return {k: [_tree(v) for v in vs] for k, vs in node.fields.items()}
    return node


def _as_nhwc(t):
    a = t.float().numpy() if isinstance(t, torch.Tensor) else t
    return a.transpose(0, 2, 3, 1) if a.ndim == 4 else a


def _assert_blobs_close(got, want, rel):
    """Every blob of the port's forward against JAX's, within ``rel`` of
    the blob's largest magnitude."""
    assert set(got) == set(want)
    for name in want:
        w = np.asarray(want[name], np.float32)
        g = _as_nhwc(got[name])
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=0, atol=rel * _scale(w),
                                   err_msg=name)


def _scale(a):
    finite = np.abs(a[np.isfinite(a)])
    return max(float(finite.max()), 1e-30) if finite.size else 1.0


# ------------------------------------------------------------- parsing

BASIC = """
input: "data"
input_shape { dim: 1 dim: 3 dim: 4 dim: 5 }
layer {
  name: "c1"  # trailing comment
  type: "Convolution"
  bottom: "data"
  top: "c1"
  convolution_param { num_output: 8 kernel_size: 3 pad: 1 stride: 2 }
  param { lr_mult: 1.0 decay_mult: true }
  include { phase: TRAIN }
}
"""


@pytest.mark.parametrize("name", ["basic", "trailnet", "yolo_standin"])
def test_parse_prototxt_matches_jax(name):
    text = {"basic": BASIC, "trailnet": emit_trailnet_prototxt(),
            "yolo_standin": yolo_standin_prototxt()}[name]
    got = parse_prototxt(text)
    assert isinstance(got, Msg)
    assert _tree(got) == _tree(jcaffe.parse_prototxt(text))


def test_emitted_trailnet_prototxt_matches_jax():
    assert emit_trailnet_prototxt() == jemit_trailnet_prototxt()


def test_parse_prototxt_errors_match_jax():
    for text in ("layer { name: \"x\"", "name \"x\""):
        with pytest.raises(ValueError) as want:
            jcaffe.parse_prototxt(text)
        with pytest.raises(ValueError) as got:
            parse_prototxt(text)
        assert str(got.value) == str(want.value)


def test_load_prototxt_and_caffemodel(tmp_path):
    (tmp_path / "n.prototxt").write_text(yolo_standin_prototxt())
    assert _tree(load_prototxt(tmp_path / "n.prototxt")) == _tree(
        jcaffe.load_prototxt(tmp_path / "n.prototxt"))
    blobs = {"fc": [np.arange(6, dtype=np.float32).reshape(2, 3)]}
    (tmp_path / "m.caffemodel").write_bytes(write_caffemodel(blobs))
    np.testing.assert_array_equal(
        load_caffemodel(tmp_path / "m.caffemodel")["fc"][0], blobs["fc"][0])


@pytest.mark.parametrize("value", [0, 1, 127, 128, 300, 2 ** 31, 2 ** 63 - 1])
def test_protolite_varint_matches_jax(value):
    enc = protolite.write_varint(value)
    assert enc == jprotolite.write_varint(value)
    assert protolite.read_varint(enc + b"\x01", 0) == (value, len(enc))


def _blob_sets():
    rs = np.random.RandomState(12345)
    return {
        "conv_fc": {"conv1": [rs.randn(8, 3, 3, 3).astype(np.float32),
                              rs.randn(8).astype(np.float32)],
                    "fc": [rs.randn(10, 72).astype(np.float32)]},
        "scalar_and_empty_dims": {"s": [np.float32(0.5) * np.ones(()),
                                        np.zeros((0,), np.float32)]},
        "trailnet_w8": native_params_to_blobs(params_from_w8_npz(TRAILNET_W8)),
    }


@pytest.mark.parametrize("name", ["conv_fc", "scalar_and_empty_dims",
                                  "trailnet_w8"])
def test_caffemodel_bytes_match_jax(name):
    blobs = _blob_sets()[name]
    data = write_caffemodel(blobs)
    jdata = jcaffe.write_caffemodel(blobs)
    assert data == jdata
    got, want = parse_caffemodel(jdata), jcaffe.parse_caffemodel(data)
    assert list(got) == list(want)
    for layer in want:
        assert len(got[layer]) == len(want[layer])
        for g, w in zip(got[layer], want[layer]):
            assert g.shape == w.shape and g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_parse_legacy_caffemodel_matches_jax():
    """V1 `layers` (field 2) with num/channels/height/width blob dims, a
    packed BlobShape, and a blob whose dims do not match its data."""
    data4 = np.arange(24, dtype="<f4")

    def blob(dims_fields, payload):
        return protolite.length_delimited(
            7, dims_fields + protolite.length_delimited(5, payload.tobytes()))

    legacy_dims = b"".join(protolite.tag(f, 0) + protolite.write_varint(d)
                           for f, d in ((1, 1), (2, 2), (3, 3), (4, 4)))
    packed = protolite.length_delimited(
        7, protolite.length_delimited(1, b"".join(
            protolite.write_varint(d) for d in (4, 6))))
    wrong = protolite.tag(2, 0) + protolite.write_varint(5)
    layer = (protolite.length_delimited(1, b"legacy")
             + blob(legacy_dims, data4) + blob(packed, data4)
             + blob(wrong, data4))
    data = protolite.length_delimited(2, layer)
    got, want = parse_caffemodel(data), jcaffe.parse_caffemodel(data)
    assert list(got) == list(want) == ["legacy"]
    for g, w in zip(got["legacy"], want["legacy"]):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w)


# ------------------------------------------------------- interpreter


def _net(extra, shape=(1, 2, 6, 6)):
    dims = " ".join(f"dim: {d}" for d in shape)
    return f'input: "data"\ninput_shape {{ {dims} }}\n' + extra


def _layer(name, typ, params="", bottoms=("data",), top=None):
    bottom = " ".join(f'bottom: "{b}"' for b in bottoms)
    return (f'layer {{ name: "{name}" type: "{typ}" {bottom} '
            f'top: "{top or name}" {params} }}\n')


# (name, prototxt body, weights (None: random), input layout). The cases of
# tests/test_caffe.py:81-160 first, then the rest of the layer set.
_RS = np.random.RandomState(4)
LAYER_CASES = [
    ("pool_max_ceil", _layer("p", "Pooling",
                             "pooling_param { pool: MAX kernel_size: 3 "
                             "stride: 2 }"), None, "nchw"),
    ("pool_ave_boundary", _layer("p", "Pooling",
                                 "pooling_param { pool: AVE kernel_size: 3 "
                                 "stride: 2 }"), None, "nchw"),
    ("pool_ave_pad", _layer("p", "Pooling",
                            "pooling_param { pool: AVE kernel_size: 3 "
                            "stride: 2 pad: 1 }"), None, "nchw"),
    # ceil((6 + 4 - 3) / 4) + 1 = 3 windows, the third clipped (pad > 0)
    ("pool_ave_clip_rule", _layer("p", "Pooling",
                                  "pooling_param { pool: AVE kernel_size: 3 "
                                  "stride: 4 pad: 2 }"), None, "nchw"),
    # pad 0: Caffe keeps the fourth window, past the input (-inf)
    ("pool_max_no_clip_without_pad", _layer(
        "p", "Pooling", "pooling_param { pool: MAX kernel_size: 1 stride: 2 "
        "}"), None, "nchw"),
    ("pool_max_pad_anisotropic", _layer(
        "p", "Pooling", "pooling_param { pool: MAX kernel_h: 3 kernel_w: 2 "
        "stride_h: 2 stride_w: 1 pad_h: 1 pad_w: 0 }"), None, "nchw"),
    ("pool_global_ave", _layer("p", "Pooling",
                               "pooling_param { pool: AVE global_pooling: "
                               "true }"), None, "nchw"),
    ("pool_global_max", _layer("p", "Pooling",
                               "pooling_param { pool: MAX global_pooling: "
                               "true }"), None, "nhwc"),
    ("inner_product_nchw_flatten", _layer(
        "fc", "InnerProduct", "inner_product_param { num_output: 4 }"),
     {"fc": [_RS.randn(4, 72).astype(np.float32),
             _RS.randn(4).astype(np.float32)]}, "nchw"),
    ("inner_product_legacy_4d", _layer(
        "fc", "InnerProduct", "inner_product_param { num_output: 4 }"),
     {"fc": [_RS.randn(1, 1, 4, 72).astype(np.float32)]}, "nhwc"),
    ("inner_product_random_lazy", _layer(
        "fc", "InnerProduct", "inner_product_param { num_output: 5 }"),
     None, "nchw"),
    ("scale_filler_constants", _layer(
        "s", "Scale", "scale_param { filler { value: 0.5 } bias_term: true "
        "bias_filler { value: -1.0 } }"), None, "nchw"),
    ("scale_learned", _layer("s", "Scale", "scale_param { bias_term: true }"),
     {"s": [_RS.randn(2).astype(np.float32),
            _RS.randn(2).astype(np.float32)]}, "nhwc"),
    ("batchnorm_global_stats", _layer("bn", "BatchNorm"),
     {"bn": [np.array([2.0, 4.0], np.float32),
             np.array([8.0, 18.0], np.float32),
             np.array([2.0], np.float32)]}, "nchw"),
    ("batchnorm_eps", _layer("bn", "BatchNorm",
                             "batch_norm_param { eps: 0.01 }"),
     {"bn": [_RS.randn(2).astype(np.float32),
             np.abs(_RS.randn(2)).astype(np.float32),
             np.array([0.0], np.float32)]}, "nchw"),
    ("relu", _layer("r", "ReLU"), None, "nchw"),
    ("relu_leaky", _layer("r", "ReLU", "relu_param { negative_slope: 0.1 }"),
     None, "nhwc"),
    ("power", _layer("pw", "Power",
                     "power_param { power: 2.0 scale: 0.5 shift: 1.5 }"),
     None, "nchw"),
    ("power_identity", _layer("pw", "Power", "power_param { shift: -2.0 }"),
     None, "nchw"),
    ("eltwise_sum", _layer("a", "ReLU") + _layer(
        "e", "Eltwise", bottoms=("data", "a", "a")), None, "nchw"),
    ("eltwise_prod", _layer("a", "ReLU") + _layer(
        "e", "Eltwise", "eltwise_param { operation: PROD }",
        bottoms=("data", "a")), None, "nchw"),
    ("eltwise_max", _layer("a", "Power", "power_param { scale: -1.0 }")
     + _layer("e", "Eltwise", "eltwise_param { operation: MAX }",
              bottoms=("data", "a")), None, "nhwc"),
    ("concat_softmax", _layer("a", "ReLU") + _layer(
        "c", "Concat", bottoms=("data", "a")) + _layer(
        "sm", "Softmax", bottoms=("c",)), None, "nchw"),
    ("dropout", _layer("d", "Dropout", "dropout_param { dropout_ratio: 0.5 }"),
     None, "nchw"),
    ("train_phase_skipped", _layer("r", "ReLU", "include { phase: TRAIN }")
     + _layer("s", "Scale", "scale_param { filler { value: 2.0 } }"),
     None, "nchw"),
    ("conv_pad_stride_random", _layer(
        "c", "Convolution", "convolution_param { num_output: 3 kernel_size: "
        "3 pad: 1 stride: 2 }"), None, "nchw"),
    ("conv_anisotropic_no_bias", _layer(
        "c", "Convolution", "convolution_param { num_output: 4 kernel_h: 3 "
        "kernel_w: 1 pad_h: 1 pad_w: 0 stride_h: 1 stride_w: 2 bias_term: "
        "false }"), None, "nhwc"),
    ("conv_given_weights_then_softmax", _layer(
        "c", "Convolution", "convolution_param { num_output: 3 kernel_size: "
        "2 }") + _layer("sm", "Softmax", bottoms=("c",)),
     {"c": [_RS.randn(3, 2, 2, 2).astype(np.float32),
            _RS.randn(3).astype(np.float32)]}, "nchw"),
]


@pytest.mark.parametrize("name,body,weights,layout", LAYER_CASES,
                         ids=[c[0] for c in LAYER_CASES])
def test_layer_matches_jax(name, body, weights, layout):
    text = _net(body)
    x = np.random.RandomState(1).randn(1, 2, 6, 6).astype(np.float32)
    if layout == "nhwc":
        x = x.transpose(0, 2, 3, 1)
    jnet = JCaffeNet(jcaffe.parse_prototxt(text), weights=weights, seed=2)
    net = CaffeNet(parse_prototxt(text), weights=weights, seed=2,
                   device="cpu")
    want = {k: np.asarray(v) for k, v in jnet.forward(x).items()}
    got = net.forward(x)
    # fp32, one layer: summation order only
    _assert_blobs_close(got, want, 1e-5)
    np.testing.assert_allclose(_as_nhwc(net(x)), want["__out__"], rtol=0,
                               atol=1e-5 * _scale(want["__out__"]))


def test_layer_semantics_as_caffe():
    """The cases of tests/test_caffe.py against Caffe's own arithmetic."""
    def run(body, x, weights=None):
        return net_out(CaffeNet(parse_prototxt(_net(body)), weights,
                                device="cpu"), x)

    def net_out(net, x):
        return net(x).numpy()

    case = {c[0]: c for c in LAYER_CASES}
    x = np.arange(72, dtype=np.float32).reshape(1, 2, 6, 6)
    # ceil mode: ceil((6 - 3) / 2) + 1 = 3, the last window clipped to [4, 6)
    out = run(case["pool_max_ceil"][1], x)
    assert out.shape == (1, 2, 3, 3)
    assert out[0, 0, 2, 2] == x[0, 0, 4:6, 4:6].max()
    # AVE of ones: every window averages to 1 whatever its clipping
    np.testing.assert_allclose(
        run(case["pool_ave_boundary"][1], np.ones_like(x)), 1.0)
    # padded cells count in the divisor, ceil-mode cells past the pad do not
    out = run(case["pool_ave_pad"][1], np.ones_like(x))
    assert out.shape == (1, 2, 4, 4)
    assert out[0, 0, 0, 0] == pytest.approx(4 / 9)
    assert out[0, 0, 3, 3] == pytest.approx(1 / 4)
    assert run(case["pool_ave_clip_rule"][1], x).shape == (1, 2, 2, 2)
    out = run(case["pool_max_no_clip_without_pad"][1], x)
    assert out.shape == (1, 2, 4, 4) and np.isneginf(out[0, :, 3]).all()
    # filler constants: 4 * 0.5 - 1
    np.testing.assert_allclose(
        run(case["scale_filler_constants"][1], np.full_like(x, 4.0)), 1.0)
    # BatchNorm: stored stats are scaled by 1 / sf
    bn = run(case["batchnorm_global_stats"][1], np.zeros_like(x),
             case["batchnorm_global_stats"][2])
    np.testing.assert_allclose(bn[0, 0], -1.0 / 2.0, atol=1e-4)
    np.testing.assert_allclose(bn[0, 1], -2.0 / 3.0, atol=1e-4)


def test_input_layout_detection():
    """NCHW where C matches the input_shape's and the last axis does not;
    otherwise NHWC; a 3D input gets a batch axis."""
    text = _net(_layer("r", "ReLU"), shape=(1, 3, 4, 5))
    net = CaffeNet(parse_prototxt(text), device="cpu")
    x = np.random.RandomState(0).randn(1, 3, 4, 5).astype(np.float32)
    np.testing.assert_array_equal(net(x).numpy(), np.maximum(x, 0))
    np.testing.assert_array_equal(net(x.transpose(0, 2, 3, 1)).numpy(),
                                  np.maximum(x, 0))
    np.testing.assert_array_equal(net(x[0].transpose(1, 2, 0)).numpy(),
                                  np.maximum(x, 0))


def test_unsupported_layer_raises():
    text = _net(_layer("x", "LRN"))
    with pytest.raises(NotImplementedError, match="LRN"):
        CaffeNet(parse_prototxt(text), device="cpu")
    with pytest.raises(NotImplementedError, match="Eltwise"):
        CaffeNet(parse_prototxt(_net(_layer(
            "e", "Eltwise", "eltwise_param { operation: DIV }",
            bottoms=("data", "data")))), device="cpu").forward(
            np.ones((1, 2, 6, 6), np.float32))


def _params_equal(got, want):
    assert list(got) == list(want)
    for name in want:
        assert len(got[name]) == len(want[name]), name
        for g, w in zip(got[name], want[name]):
            if isinstance(w, tuple):
                assert g == w, name
                continue
            g, w = np.asarray(g), np.asarray(w)
            assert g.shape == w.shape and g.dtype == w.dtype, name
            np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("seed", [0, 3])
def test_random_weights_bit_equal_to_jax(seed):
    """The random draws, number for number, the lazy InnerProduct's at its
    first forward included; then the net itself agrees blob for blob."""
    text = yolo_standin_prototxt()
    jnet = JCaffeNet(jcaffe.parse_prototxt(text), seed=seed)
    net = CaffeNet(parse_prototxt(text), seed=seed, device="cpu")
    _params_equal(net.params, jnet.params)
    assert net.params["fc"] == [("lazy_ip", 1470, seed)]
    frame = np.random.RandomState(seed).randint(
        0, 256, (448, 448, 3)).astype(np.uint8)
    want = {k: np.asarray(v) for k, v in
            jnet.forward(frame.astype(np.float32)).items()}
    got = net.forward(frame)
    _params_equal(net.params, jnet.params)
    assert net.params["fc"][0].shape == (1470, 7 * 7 * 8)
    # fp32 through four convs and the head: summation order, relative to
    # each blob's largest magnitude
    _assert_blobs_close(got, want, 1e-4)
    assert got["__out__"].shape == (1, 1470)


def test_trailnet_random_weights_bit_equal_to_jax():
    """The emitted TrailNet prototxt with no weights: every filler (conv
    He-init, Scale constants) and both lazy heads drawn as JAX draws them;
    the random net saturates, so only the draws are compared here."""
    text = emit_trailnet_prototxt()
    jnet = JCaffeNet(jcaffe.parse_prototxt(text), seed=5)
    net = CaffeNet(parse_prototxt(text), seed=5, device="cpu")
    _params_equal(net.params, jnet.params)
    for name in ("fc3", "fc3_t"):
        # draw each head as its first forward does, on the pooled features
        net._inner_product(name, torch.zeros(1, 512, 1, 1))
        jnet._inner_product(name, np.zeros((1, 1, 1, 512), np.float32),
                            jnet.params)
    _params_equal(net.params, jnet.params)


def test_trailnet_caffe_weights_round_trip(tmp_path):
    """native tree -> blobs -> caffemodel bytes -> CaffeNet: the served
    weights are the w8 artifact's, bit for bit, as in JAX."""
    tree = params_from_w8_npz(TRAILNET_W8)
    path = tmp_path / "t.caffemodel"
    path.write_bytes(write_caffemodel(native_params_to_blobs(tree)))
    net = CaffeNet(parse_prototxt(emit_trailnet_prototxt()),
                   load_caffemodel(path), device="cpu")
    jnet = JCaffeNet(jcaffe.parse_prototxt(jemit_trailnet_prototxt()),
                     jcaffe.load_caffemodel(path))
    _params_equal(net.params, jnet.params)
    np.testing.assert_array_equal(net.params["conv1"][0],
                                  np.transpose(jparams_w8(TRAILNET_W8)
                                               ["conv1"]["w"], (3, 2, 0, 1)))


def test_yolo_standin_matches_jax():
    """The YOLO-shaped graph at its full 448x448 -> 1470, given weights."""
    text = yolo_standin_prototxt()
    rs = np.random.RandomState(8)
    shapes = {"conv1": (8, 3, 7, 7), "conv2": (16, 8, 3, 3),
              "conv3": (16, 16, 3, 3), "conv4": (8, 16, 1, 1),
              "fc": (1470, 392)}
    weights = {n: [(rs.randn(*s) / np.sqrt(np.prod(s[1:]))).astype(
        np.float32), (rs.randn(s[0]) * 0.1).astype(np.float32)]
        for n, s in shapes.items()}
    frame = rs.randint(0, 256, (1, 448, 448, 3)).astype(np.uint8)
    want = np.asarray(JCaffeNet(jcaffe.parse_prototxt(text), weights)(
        frame.astype(np.float32)))
    got = CaffeNet(parse_prototxt(text), weights, device="cpu")(frame)
    assert got.shape == want.shape == (1, 1470)
    # fp32 through four convs and the head: summation order
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


# ---------------------------------------------------------------- YOLO


def _pred(cells):
    """A (1470,) head from (row, col, label, class_p, (conf0, conf1),
    (box0, box1)) entries."""
    p = np.zeros(7 * 7 * 30, np.float32)
    for row, col, label, class_p, confs, boxes in cells:
        icell = row * 7 + col
        p[icell * 20 + label] = class_p
        for b in range(2):
            p[49 * 20 + icell * 2 + b] = confs[b]
            k = 49 * 22 + (icell * 2 + b) * 4
            p[k:k + 4] = boxes[b]
    return p


def _yolo_cases():
    rs = np.random.RandomState(21)
    return {
        # grid scan order, not probability order; the second box wins a
        # cell by confidence
        "scan_order": _pred([(0, 6, 3, 0.5, (0.3, 0.6), ([0.5] * 4,
                                                         [0.5, 0.5, .6, .6])),
                             (1, 0, 3, 0.9, (0.9, 0.1), ([0.5] * 4,) * 2)]),
        # class-blind suppression: overlapping boxes of two labels
        "class_blind": _pred([(3, 3, 14, 0.9, (0.8, 0), ([0.5, .5, .5, .5],
                                                          [0] * 4)),
                              (3, 4, 7, 0.9, (0.7, 0), ([0.1, .5, .5, .5],
                                                         [0] * 4))]),
        # containment: a small box inside a large one over-counts the
        # intersection
        "containment": _pred([(3, 3, 1, 0.9, (0.9, 0), ([.5, .5, .9, .9],
                                                        [0] * 4)),
                              (4, 4, 1, 0.9, (0.8, 0), ([.1, .1, .2, .2],
                                                        [0] * 4))]),
        # zero area after truncation, negative w/h, clamping at the edges
        "zero_area_and_edges": _pred([
            (0, 0, 2, 0.9, (0.9, 0), ([0.0, 0.0, 0.01, 0.5], [0] * 4)),
            (6, 6, 2, 0.9, (0.9, 0), ([0.99, 0.99, 0.9, 0.9], [0] * 4)),
            (2, 2, 2, 0.9, (0.9, 0), ([0.5, 0.5, -0.4, 0.4], [0] * 4)),
            (5, 1, 2, 0.9, (0.9, 0), ([0.0, 0.9, 0.95, 0.05], [0] * 4))]),
        "random_uniform": rs.rand(1470).astype(np.float32),
        "random_normal": rs.randn(1470).astype(np.float32),
    }


def _rows(preds):
    return [tuple(p.as_row()) for p in preds]


@pytest.mark.parametrize("name", list(_yolo_cases()))
@pytest.mark.parametrize("img_wh", [(448, 448), (640, 360), (37, 1000)])
def test_yolo_postprocess_equals_jax(name, img_wh):
    p = _yolo_cases()[name]
    w, h = img_wh
    for thresh in (0.05, 0.1, 0.15, 0.5):
        got = yolo.decode(p, w, h, thresh)
        want = jyolo.decode(p, w, h, thresh)
        assert _rows(got) == _rows(want)
        for iou in (0.0, 0.2, 0.5, 0.9):
            assert _rows(yolo.filter_by_iou(got, iou)) == _rows(
                jyolo.filter_by_iou(want, iou))
    for kwargs in ({}, {"prob_threshold": 0.05, "iou_threshold": 0.5}):
        got = yolo.postprocess(p, w, h, **kwargs)
        want = jyolo.postprocess(p, w, h, **kwargs)
        assert got.dtype == want.dtype == np.float32
        assert got.shape == want.shape and got.shape[1:] == (6,)
        np.testing.assert_array_equal(got, want)


def test_yolo_quirks_hold():
    """The reference's quirks the copy keeps, on the hand-made heads."""
    cases = _yolo_cases()
    scan = yolo.decode(cases["scan_order"], 448, 448, 0.1)
    assert [p.prob for p in scan] == pytest.approx([0.3, 0.81])
    blind = yolo.postprocess(cases["class_blind"], 448, 448,
                             iou_threshold=0.2)
    assert blind[:, 0].tolist() == [14.0]  # the label-7 box went with it
    kept = yolo.filter_by_iou(
        [yolo.ObjectPrediction(1, 0.9, 0, 0, 100, 100),
         yolo.ObjectPrediction(1, 0.8, 40, 40, 10, 10)], 0.2)
    # contained box: the over-counted intersection gives IoU 0.33, where
    # the true one is 0.01
    assert len(kept) == 1
    zero = yolo.decode(cases["zero_area_and_edges"], 448, 448, 0.1)
    assert all(p.w > 0 and p.h > 0 for p in zero)
    assert len(zero) < 4
    assert yolo.VOC_LABELS[yolo.PERSON_CLASS] == "person"
    assert yolo.VOC_LABELS == jyolo.VOC_LABELS
    assert yolo.PERSON_CLASS == jyolo.PERSON_CLASS
