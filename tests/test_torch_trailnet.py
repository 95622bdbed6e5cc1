"""The port's TrailNet slice against the JAX package's, on the CPU, at the
full 180x320 with the repository's trained w8 weights
(`tests/data/trailnet_synth_trained.npz`): the `CaffeNet` interpreter over
the emitted prototxt, the native SResNet-18, the weight artifacts, `srelu`,
the `caffe_ros` preprocessing, and the serving nodes (`TrailNetNode`, and
`YoloNode` on the YOLO-shaped stand-in graph of `test_torch_caffe.py`).

Random He-init weights saturate TrailNet's softmax (0.9999), so the
probabilities are compared with the trained weights; each tolerance is
stated with its reason.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from redtail_tpu.io import caffe as jcaffe
from redtail_tpu.models import trailnet as jtrailnet
from redtail_tpu.models.caffe_net import CaffeNet as JCaffeNet
from redtail_tpu.models.trailnet_proto import (
    native_params_to_blobs as jnative_params_to_blobs,
)
from redtail_tpu.ops.activations import srelu as jsrelu
from redtail_tpu.ops.preprocess import (
    preprocess_caffe_host as jpreprocess_caffe_host,
)
from redtail_tpu.runtime.nodes import TrailNetNode as JTrailNetNode
from redtail_tpu.runtime.nodes import YoloNode as JYoloNode

from redtail_tpu_torch.io import parse_prototxt, write_caffemodel
from redtail_tpu_torch.models import (
    CaffeNet,
    TrailNet,
    emit_trailnet_prototxt,
    init_trailnet_params,
    load_trailnet,
    native_params_to_blobs,
    params_from_w8_npz,
    params_to_w8_npz,
    trailnet_forward,
    trailnet_predict,
)
from redtail_tpu_torch.models.trailnet import params_from_numpy, params_to_numpy
from redtail_tpu_torch.ops import preprocess_caffe_host, srelu
from redtail_tpu_torch.runtime import TrailNetNode, YoloNode
from test_torch_caffe import yolo_standin_prototxt

TRAILNET_W8 = Path(__file__).resolve().parent / "data" / \
    "trailnet_synth_trained.npz"
HW = (180, 320)
# fp32 on both sides: the convs' summation order through 20 layers, in
# probability units (measured ~2e-6)
FP32_ATOL = 1e-4
# bf16 against JAX's own bf16 forward: both round once per conv, so they
# differ where one bf16 ulp of an activation flips; JAX's bf16 is itself up
# to 1.09e-2 off its fp32 (CaffeNet) and 2.9e-3 (native)
BF16_MAX, BF16_MEAN = 3e-2, 5e-3


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Full-size CPU forwards: a few intra-op threads, so that parallel
    test workers do not oversubscribe the cores (restored after)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, 2))
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def tree():
    return params_from_w8_npz(TRAILNET_W8)


@pytest.fixture(scope="module")
def frames():
    return np.random.RandomState(0).randint(0, 256, (2,) + HW + (3,)).astype(
        np.uint8)


def _jax_caffe(dtype=jnp.float32):
    blobs = jnative_params_to_blobs(jtrailnet.params_from_w8_npz(TRAILNET_W8))
    return JCaffeNet(jcaffe.parse_prototxt(emit_trailnet_prototxt()), blobs,
                     dtype=dtype)


@pytest.fixture(scope="module")
def jax_refs(frames):
    """JAX's outputs on ``frames``: each form in fp32 and bf16, and the
    native logits (computed once; the first eager call of each takes
    seconds)."""
    x = frames.astype(np.float32)
    refs = {}
    for name, dtype in (("fp32", jnp.float32), ("bf16", jnp.bfloat16)):
        jtree = jtrailnet.params_from_w8_npz(TRAILNET_W8, dtype=dtype)
        refs[("native", name)] = np.asarray(jtrailnet.trailnet_forward(
            jtree, jnp.asarray(x, dtype)).astype(jnp.float32))
        refs[("caffe", name)] = np.asarray(_jax_caffe(dtype)(x).astype(
            jnp.float32))
    logits = jtrailnet.trailnet_forward(
        jtrailnet.params_from_w8_npz(TRAILNET_W8), x, return_logits=True)
    refs["logits"] = tuple(np.asarray(z) for z in logits)
    return refs


def _port(form, tree, dtype):
    if form == "native":
        return params_from_numpy(tree, device="cpu", dtype=dtype)
    return CaffeNet(parse_prototxt(emit_trailnet_prototxt()),
                    native_params_to_blobs(tree), dtype=dtype, device="cpu")


@pytest.fixture(scope="module")
def nets(tree):
    """The port's nets, each form in each dtype, built once."""
    return {(form, dtype): _port(form, tree, dtype)
            for form in ("caffe", "native")
            for dtype in (torch.float32, torch.bfloat16)}


@pytest.mark.parametrize("form", ["caffe", "native"])
def test_fp32_matches_jax(form, nets, frames, jax_refs):
    with torch.inference_mode():
        got = nets[(form, torch.float32)](torch.from_numpy(frames))
    want = jax_refs[(form, "fp32")]
    assert got.dtype == torch.float32 and got.shape == want.shape == (2, 6)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FP32_ATOL)
    # two softmax groups, and the trained weights do not saturate them
    np.testing.assert_allclose(want.reshape(2, 2, 3).sum(-1), 1.0, atol=1e-5)
    assert 0.05 < want[0, 0] < 0.95


@pytest.mark.parametrize("form", ["caffe", "native"])
def test_bf16_matches_jax(form, nets, frames, jax_refs):
    with torch.inference_mode():
        got = nets[(form, torch.bfloat16)](torch.from_numpy(frames))
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - jax_refs[(form, "bf16")])
    assert err.max() <= BF16_MAX and err.mean() <= BF16_MEAN, (
        err.max(), err.mean())


def test_logits_match_jax(nets, frames, jax_refs):
    with torch.inference_mode():
        got = trailnet_forward(nets[("native", torch.float32)],
                               torch.from_numpy(frames).float(),
                               return_logits=True)
    for g, w in zip(got, jax_refs["logits"]):
        assert g.dtype == torch.float32 and g.shape == w.shape == (2, 3)
        # fp32 summation order, relative to the logits' scale
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max())


def test_trailnet_forward_takes_the_tree(tree, nets, frames):
    """``params`` as a numpy tree is built on x's device in x's dtype."""
    x = torch.from_numpy(frames[:1]).float()
    net = nets[("native", torch.float32)]
    with torch.inference_mode():
        np.testing.assert_array_equal(trailnet_forward(tree, x).numpy(),
                                      net(x).numpy())


def test_logits_train_every_layer(tree, frames):
    """The training path: a loss on the logits reaches every parameter
    (no CUDA kernel lies on this path, so the same holds on the card)."""
    net = params_from_numpy(tree, device="cpu")
    fc3, fc3_t = net(torch.from_numpy(frames[:1]), return_logits=True)
    (fc3.logsumexp(-1) + fc3_t.logsumexp(-1)).sum().backward()
    for name, p in net.named_parameters():
        assert p.grad is not None and p.grad.abs().sum() > 0, name


def test_trunk_size_guard():
    net = params_from_numpy(init_trailnet_params(), device="cpu")
    with pytest.raises(ValueError, match=r"\(6, 10\)"):
        net(torch.zeros(1, 100, 200, 3))


def test_trailnet_predict(nets, frames, jax_refs):
    with torch.inference_mode():
        got = trailnet_predict(nets[("caffe", torch.float32)], frames[0])
        native = trailnet_predict(nets[("native", torch.float32)], frames[0])
    assert got.shape == native.shape == (1, 6)
    np.testing.assert_allclose(got.numpy(), jax_refs[("caffe", "fp32")][:1],
                               rtol=0, atol=FP32_ATOL)
    np.testing.assert_allclose(native.numpy(), got.numpy(), rtol=0,
                               atol=FP32_ATOL)


def test_srelu_bf16_bit_equal_to_jax():
    """Every bf16 bit pattern (NaNs compared as NaNs)."""
    bits = np.arange(1 << 16, dtype=np.uint16)
    want = np.asarray(jsrelu(jax.lax.bitcast_convert_type(
        jnp.asarray(bits), jnp.bfloat16))).view(np.uint16)
    got = srelu(torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16))
    got = got.view(torch.int16).numpy().view(np.uint16)

    def nan(b):
        return ((b & 0x7F80) == 0x7F80) & ((b & 0x7F) != 0)
    np.testing.assert_array_equal(nan(got), nan(want))
    np.testing.assert_array_equal(got[~nan(got)], want[~nan(want)])
    # not clamp(x, min=-1): x + 1 rounds in bf16 (2^-9 + 1 -> 1, so 0)
    x = torch.tensor([2.0 ** -9], dtype=torch.bfloat16)
    assert srelu(x).item() == 0.0 and x.clamp(min=-1).item() == 2.0 ** -9


def test_srelu_fp32_matches_jax():
    x = np.random.RandomState(3).randn(4096).astype(np.float32) * 3
    np.testing.assert_array_equal(srelu(torch.from_numpy(x)).numpy(),
                                  np.asarray(jsrelu(jnp.asarray(x))))


def test_w8_artifact_round_trips_across_packages(tmp_path):
    """JAX writes, the port reads; the port writes, JAX reads: the same
    arrays bit for bit, and both writers give the same npz entries."""
    tree = init_trailnet_params(seed=3)
    jtrailnet.params_to_w8_npz(tree, tmp_path / "jax.npz")
    params_to_w8_npz(tree, tmp_path / "port.npz")
    with np.load(tmp_path / "jax.npz") as a, np.load(tmp_path / "port.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for path in (tmp_path / "jax.npz", tmp_path / "port.npz"):
        got = params_from_w8_npz(path)
        want = jtrailnet.params_from_w8_npz(path)
        assert list(got) == list(want)
        for name in want:
            for leaf in ("w", "b"):
                np.testing.assert_array_equal(got[name][leaf],
                                              np.asarray(want[name][leaf]))


def test_w8_artifact_from_the_module(tree, tmp_path):
    net = params_from_numpy(tree, device="cpu")
    params_to_w8_npz(net, tmp_path / "m.npz")
    back = params_from_w8_npz(tmp_path / "m.npz")
    for name in tree:
        np.testing.assert_array_equal(back[name]["b"], tree[name]["b"])
        # the committed artifact's weights are already on the int8 grid;
        # quantizing them again moves each by at most one step
        np.testing.assert_allclose(back[name]["w"], tree[name]["w"], rtol=0,
                                   atol=np.abs(tree[name]["w"]).max() / 127)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_params_numpy_round_trip(tree, dtype):
    back = params_to_numpy(params_from_numpy(tree, device="cpu", dtype=dtype))
    assert set(back) == set(tree)
    for name in tree:
        for leaf in ("w", "b"):
            want = torch.from_numpy(np.asarray(tree[name][leaf])).to(
                dtype).float().numpy()
            assert back[name][leaf].shape == want.shape
            np.testing.assert_array_equal(back[name][leaf], want)


def test_init_trailnet_params_shapes_match_jax():
    """The JAX package's native tree (its loader on the committed
    artifact): the same layer names and shapes."""
    got = init_trailnet_params(seed=1)
    want = jtrailnet.params_from_w8_npz(TRAILNET_W8)
    assert set(got) == set(want)
    for name in want:
        for leaf in ("w", "b"):
            assert got[name][leaf].shape == want[name][leaf].shape, name
            assert got[name][leaf].dtype == np.float32
        assert not got[name]["b"].any()
    w = got["res4_1_1"]["w"]
    assert abs(w.std() - np.sqrt(2.0 / (9 * 256))) < 0.01 * w.std() + 1e-3
    again = init_trailnet_params(seed=1)
    for name in got:
        np.testing.assert_array_equal(got[name]["w"], again[name]["w"])


@pytest.mark.parametrize("encoding,inp_fmt", [
    ("bgr8", "BGR"), ("rgb8", "BGR"), ("bgra8", "BGR"), ("bgr8", "RGB"),
    ("bgra8", "RGB"), ("mono8", "BGR")])
@pytest.mark.parametrize("scale,shift", [(1.0, 0.0), (1 / 255.0, -0.5)])
def test_preprocess_caffe_host_matches_jax(encoding, inp_fmt, scale, shift):
    channels = {"bgra8": 4, "mono8": 3}.get(encoding, 3)
    img = np.random.RandomState(5).randint(0, 256, (97, 151, channels)).astype(
        np.uint8)
    kwargs = dict(encoding=encoding, inp_fmt=inp_fmt, scale=scale,
                  shift=shift)
    got = preprocess_caffe_host(img, 320, 180, **kwargs)
    want = jpreprocess_caffe_host(img, 320, 180, **kwargs)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------- nodes


@pytest.fixture(scope="module")
def jax_trailnet_node():
    return JTrailNetNode(_jax_caffe())


@pytest.mark.parametrize("size", [HW, (240, 427)], ids=["180x320", "resized"])
@pytest.mark.parametrize("form", ["caffe", "native"])
def test_trailnet_node_matches_jax_node(form, size, nets, jax_trailnet_node):
    frame = np.random.RandomState(6).randint(0, 256, size + (3,)).astype(
        np.uint8)
    want = jax_trailnet_node(frame)
    node = TrailNetNode(nets[(form, torch.float32)], device="cpu")
    got = node(frame)
    assert got.shape == (6,) and got.dtype == np.float32
    # the same host resize (cv2 INTER_CUBIC on uint8) on both sides, then
    # fp32 as in test_fp32_matches_jax
    np.testing.assert_allclose(got, want, rtol=0, atol=FP32_ATOL)
    np.testing.assert_allclose(node(frame[None]), got, rtol=0, atol=0)
    assert set(node.profiler.stats()) == {"trailnet/pack", "trailnet"}


def test_trailnet_node_serves_bf16(nets):
    frame = np.random.RandomState(7).randint(0, 256, HW + (3,)).astype(
        np.uint8)
    net = nets[("caffe", torch.bfloat16)]
    got = TrailNetNode(net, device="cpu")(frame)
    assert got.dtype == np.float32
    with torch.inference_mode():
        np.testing.assert_array_equal(got, net(frame).float().numpy()[0])


def _yolo_nets(seed=2):
    text = yolo_standin_prototxt()
    jnet = JCaffeNet(jcaffe.parse_prototxt(text), seed=seed)
    net = CaffeNet(parse_prototxt(text), seed=seed, device="cpu")
    return jnet, net


@pytest.mark.parametrize("size", [(448, 448), (300, 500)],
                         ids=["448x448", "resized"])
def test_yolo_node_matches_jax_node(size):
    jnet, net = _yolo_nets()
    frame = np.random.RandomState(8).randint(0, 256, size + (3,)).astype(
        np.uint8)
    # a low threshold, so the random head yields boxes to compare
    want = JYoloNode(jnet, prob_threshold=0.01)(frame)
    node = YoloNode(net, prob_threshold=0.01, device="cpu")
    got = node(frame)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape and got.shape[1:] == (6,)
    assert len(got) > 0
    # boxes and labels exactly (integers from the same decode); the
    # probabilities within the fp32 summation order of the raw head
    np.testing.assert_array_equal(got[:, [0, 2, 3, 4, 5]],
                                  want[:, [0, 2, 3, 4, 5]])
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=0, atol=1e-5)
    assert (got[:, 2] + got[:, 4] <= size[1]).all()
    assert (got[:, 3] + got[:, 5] <= size[0]).all()
    assert set(node.profiler.stats()) == {"yolo/dnn", "yolo/postproc"}


def test_load_trailnet(tree, nets, tmp_path, frames):
    (tmp_path / "t.prototxt").write_text(emit_trailnet_prototxt())
    (tmp_path / "t.caffemodel").write_bytes(
        write_caffemodel(native_params_to_blobs(tree)))
    net = load_trailnet(tmp_path / "t.prototxt", tmp_path / "t.caffemodel",
                        device="cpu")
    with torch.inference_mode():
        np.testing.assert_array_equal(
            net(frames[:1]).numpy(),
            nets[("caffe", torch.float32)](frames[:1]).numpy())
    # the default prototxt is the reference's, absent here as for JAX
    with pytest.raises(FileNotFoundError):
        load_trailnet(device="cpu")
    with pytest.raises(FileNotFoundError):
        jtrailnet.load_trailnet()


@pytest.mark.parametrize("kwargs", [{"device": "cuda:1"}], ids=str)
def test_trailnet_node_later_slices_raise(kwargs, nets, monkeypatch):
    """A stage pins to any card that is there; a missing one raises (one
    card here: CUDA faked available, checked before any allocation)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    kwargs.setdefault("device", "cpu")
    with pytest.raises(RuntimeError, match="cuda:1: only 1 card"):
        TrailNetNode(nets[("native", torch.float32)], **kwargs)


@pytest.mark.parametrize("kwargs", [{"device": "cuda:1"}], ids=str)
def test_yolo_node_later_slices_raise(kwargs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    kwargs.setdefault("device", "cpu")
    with pytest.raises(RuntimeError, match="cuda:1: only 1 card"):
        YoloNode(_yolo_nets()[1], **kwargs)


def test_nodes_reject_batches(nets):
    trail = TrailNetNode(nets[("native", torch.float32)], device="cpu")
    with pytest.raises(ValueError, match="one frame per call"):
        trail(np.zeros((2,) + HW + (3,), np.uint8))
    yolo_node = YoloNode(_yolo_nets()[1], device="cpu")
    with pytest.raises(ValueError, match="one frame per call"):
        yolo_node(np.zeros((2, 448, 448, 3), np.uint8))


def test_trailnet_is_a_module(tree):
    net = params_from_numpy(tree, device="cpu", dtype=torch.bfloat16)
    assert isinstance(net, TrailNet) and net.dtype == torch.bfloat16
    assert net.device == torch.device("cpu")
    assert sum(p.numel() for p in net.parameters()) == sum(
        tree[n]["w"].size + tree[n]["b"].size for n in tree)
