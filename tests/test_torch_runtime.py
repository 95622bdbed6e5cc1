"""The port's serving runtime on the CPU against the JAX package's: the node
graph (`runtime/graph.py`, the contracts of `tests/test_runtime.py`),
sources, telemetry and viz, and the serving nodes' frames-in-flight
machinery (`runtime/nodes.py`: overlap, microbatch, true stamps, the u16
wire, warm-up and drain, `tap_stage`, the rejections) fed the same frames
and stamps as the JAX nodes.

Every test that starts threads bounds each wait by a deadline of a few
seconds."""

import dataclasses
import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from redtail_tpu.io.caffe import parse_prototxt as jparse_prototxt
from redtail_tpu.models import STEREO_SPECS as JSPECS
from redtail_tpu.models.caffe_net import CaffeNet as JCaffeNet
from redtail_tpu.runtime import graph as jgraph
from redtail_tpu.runtime import nodes as jnodes
from redtail_tpu.runtime import sources as jsources
from redtail_tpu.runtime import viz as jviz

from redtail_tpu_torch.io import parse_prototxt
from redtail_tpu_torch.models import STEREO_SPECS, CaffeNet, init_stereo_params
from redtail_tpu_torch.runtime import (
    ApproxTimeSync,
    NodeGraph,
    StageProfiler,
    Stamped,
    StereoNode,
    Topic,
    TrailNetNode,
    VizNode,
    YoloNode,
    disp_to_color,
    make_mosaic,
    tap_stage,
)
from redtail_tpu_torch.runtime import graph
from redtail_tpu_torch.runtime.graph import Node
from redtail_tpu_torch.runtime.sources import SyntheticSource
from redtail_tpu_torch.runtime.telemetry import Telemetry
from test_torch_caffe import yolo_standin_prototxt
from test_torch_stereo import conditioned

HW = (64, 128)
WAIT = 5.0  # seconds: the deadline of every wait on a thread


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """A few intra-op threads, so that parallel test workers do not
    oversubscribe the cores (restored after)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, 2))
    yield
    torch.set_num_threads(saved)


def _spec():
    return dataclasses.replace(STEREO_SPECS["resnet18_2d"], input_hw=HW,
                               max_disp=8)


def _jspec():
    return dataclasses.replace(JSPECS["resnet18_2d"], input_hw=HW,
                               max_disp=8)


@pytest.fixture(scope="module")
def params():
    return conditioned(init_stereo_params(_spec(), seed=1))


def _frames(n, seed=0):
    rs = np.random.RandomState(seed)
    return [(rs.randint(0, 256, HW + (3,)).astype(np.uint8),
             rs.randint(0, 256, HW + (3,)).astype(np.uint8))
            for _ in range(n)]


@pytest.fixture(scope="module")
def sync_out(params):
    """The port's synchronous fp32 node on frames 0..5 of seed 0."""
    node = StereoNode(_spec(), params, dtype=torch.float32, device="cpu")
    return [node(*f) for f in _frames(6)]


# ------------------------------------------------------------ node graph


def test_topic_latest_wins():
    t = Topic("x")
    assert t.latest() is None
    t.publish(1)
    t.publish(2)
    m = t.latest()
    assert m.data == 2 and m.seq == 2
    assert t.take(last_seq=2) is None
    t.publish(3)
    assert t.take(last_seq=2).data == 3
    assert t.count == 3


def test_topic_history_take_since():
    t = Topic("x", history=3)
    for i in range(5):
        t.publish(i, stamp=float(i))
    assert t.count == 5 and t.latest().data == 4 and t.take(0).data == 4
    got = t.take_since(0)
    assert [m.data for m in got] == [2, 3, 4]
    assert [m.seq for m in got] == [3, 4, 5]
    t.set_history(5)
    assert [m.data for m in t.take_since(0)] == [2, 3, 4]
    t.set_history(1)  # never shrinks
    assert len(t.take_since(0)) == 3
    g = NodeGraph()
    a = g.topic("a")
    assert g.topic("a", history=4) is a
    for i in range(4):
        a.publish(i)
    assert len(a.take_since(0)) == 4


def test_approx_time_sync_two_and_three_way():
    a, b, c = Topic("a"), Topic("b"), Topic("c")
    sync = ApproxTimeSync(a, b, slop=0.05)
    a.publish("L", stamp=1.00)
    b.publish("R", stamp=1.20)
    assert sync.take() is None  # outside the slop
    b.publish("R2", stamp=1.01)
    assert [m.data for m in sync.take()] == ["L", "R2"]
    assert sync.take() is None  # the same pair is not delivered twice
    sync3 = ApproxTimeSync(a, b, c, slop=0.05)
    assert sync3.take() is None  # c missing
    c.publish(3, stamp=1.02)
    assert [m.data for m in sync3.take()] == ["L", "R2", 3]
    with pytest.raises(ValueError, match="at least two"):
        ApproxTimeSync(a)


def test_graph_publishes_as_jax_graph_does():
    """One scripted sequence through a port `Node` and a JAX `Node`
    (`step_once`, no threads): the same messages, stamps and sequence
    numbers, for plain, `Stamped`, list-of-`Stamped` and plain-list
    results and a stage that raises."""
    def stage(x, stamp=None):
        if x == 3:
            raise RuntimeError("boom")
        if x % 4 == 0:
            return None
        if x % 4 == 1:
            return [x, x + 1]  # a plain list: one message
        return [mod.Stamped(x, stamp - 1.0), mod.Stamped(x + 1, stamp - 0.5)]
    stage.needs_stamp = True
    seen = {}
    for mod in (jgraph, graph):
        src, dst = mod.Topic("in"), mod.Topic("out", history=64)
        node = mod.Node("s", stage, [src], dst, max_rate_hz=1000)
        for i in range(10):
            src.publish(i, stamp=100.0 + i)
            node.step_once()
        seen[mod.__name__] = ([(m.data, m.stamp, m.seq)
                               for m in dst.take_since(0)],
                              node.processed, node.errors)
    (got, want) = seen.values()
    assert got == want and want[2] == 1 and want[0]


def test_node_graph_threads_and_error_recovery():
    g = NodeGraph()
    out_log = []

    def flaky(x):
        if x == 0:
            raise RuntimeError("boom")
        return x * 2

    g.add_node("double", flaky, ["in"], "mid", max_rate_hz=200)
    g.add_node("collect", lambda x: out_log.append(x), ["mid"], None,
               max_rate_hz=200)
    g.start()
    try:
        g.topic("in").publish(0)
        assert g.spin_until(lambda: g.nodes["double"].errors >= 1,
                            timeout=WAIT)
        for i in range(1, 4):
            g.topic("in").publish(i)
            time.sleep(0.02)
        assert g.spin_until(lambda: len(out_log) >= 2, timeout=WAIT)
    finally:
        g.stop()
    assert all(v % 2 == 0 for v in out_log)
    assert isinstance(g.nodes["double"].last_error, RuntimeError)
    assert not any(n._thread.is_alive() for n in g.nodes.values())


def test_watchdog_and_restart_of_a_wedged_node():
    """A node wedged in its callable shows as stalled; a restart leaves
    exactly one consumer once the old thread unwedges."""
    g = NodeGraph()
    release = threading.Event()
    calls = []

    def fn(x):
        calls.append(x)
        if x == "wedge":
            release.wait(WAIT)
        return x

    node = g.add_node("n", fn, ["in"], "out", max_rate_hz=500)
    g.start()
    try:
        g.topic("in").publish("wedge")
        assert g.spin_until(lambda: len(calls) == 1, timeout=WAIT)
        time.sleep(0.3)
        assert "n" in g.stalled_nodes(max_silence_sec=0.2)
        old = node._thread
        assert g.restart_node("n", timeout=0.2) is False  # did not join
        g.topic("in").publish("a")
        assert g.spin_until(lambda: "a" in calls, timeout=WAIT)
        release.set()
        assert g.spin_until(lambda: not old.is_alive(), timeout=WAIT)
        n_calls = len(calls)
        g.topic("in").publish("b")
        assert g.spin_until(lambda: "b" in calls, timeout=WAIT)
        assert len(calls) == n_calls + 1  # exactly one consumer
        assert g.restart_node("n") is True  # an idle node joins cleanly
    finally:
        release.set()
        g.stop()


def test_synthetic_source_matches_jax_frames():
    t, jt = Topic("cam"), jgraph.Topic("cam")
    src = SyntheticSource(t, shape=(8, 8, 3), rate_hz=200, count=10)
    jsrc = jsources.SyntheticSource(jt, shape=(8, 8, 3), rate_hz=200,
                                    count=10)
    for s in (src, jsrc):
        s.start()
    deadline = time.monotonic() + WAIT
    while (src.published < 10 or jsrc.published < 10) \
            and time.monotonic() < deadline:
        time.sleep(0.01)
    for s in (src, jsrc):
        s.stop()
    assert src.published == jsrc.published == 10
    np.testing.assert_array_equal(t.latest().data, jt.latest().data)


def test_profiler_and_telemetry():
    from redtail_tpu_torch.control import Controller, ControllerConfig, Drone
    p = StageProfiler()
    for _ in range(10):
        with p.stage("a"):
            pass
    p.record("b", 0.010)
    assert p.stats()["a"]["count"] == 10
    assert p.stats()["b"]["mean_ms"] == pytest.approx(10.0)
    ctl = Controller(Drone(), ControllerConfig())
    records = []
    tel = Telemetry(interval_sec=0.01, sink=records.append)
    tel.add_controller(ctl)
    tel.add_probe("boom", lambda: 1 / 0)  # a probe must not kill it
    rec = tel.sample()
    assert rec["state"] == "NOOP" and rec["ai_score"] == 0.0
    assert "err" in rec["boom"]
    tel.start()
    deadline = time.monotonic() + WAIT
    while len(tel.records) <= 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    tel.stop()
    assert len(tel.records) > 3 and not tel._thread.is_alive()


def test_viz_matches_jax():
    rs = np.random.RandomState(0)
    disp = (rs.rand(20, 30) * 110).astype(np.float32)  # past max_disp too
    np.testing.assert_array_equal(disp_to_color(disp, 96.0),
                                  jviz.disp_to_color(disp, 96.0))
    left, right = (rs.randint(0, 256, (20, 30, 3)).astype(np.uint8)
                   for _ in range(2))
    got = make_mosaic(left, right, disp)
    assert got.shape == (40, 60, 3)
    np.testing.assert_array_equal(got, jviz.make_mosaic(left, right, disp))


def test_viz_node_writes_mosaics(tmp_path):
    cv2 = pytest.importorskip("cv2")
    viz = VizNode(tmp_path / "viz", every=2)
    rs = np.random.RandomState(0)
    left, right = (rs.randint(0, 256, (20, 30, 3)).astype(np.uint8)
                   for _ in range(2))
    for _ in range(5):
        viz(left, right, rs.rand(20, 30).astype(np.float32) * 90)
    files = sorted((tmp_path / "viz").glob("mosaic_*.png"))
    assert viz.frames == 5 and viz.written == 3 and len(files) == 3
    assert cv2.imread(str(files[0])).shape == (40, 60, 3)


# ---------------------------------------------------------- StereoNode


def _jax_node(params, **kw):
    return jnodes.StereoNode(_jspec(), jax.tree.map(jnp.asarray, params),
                             dtype=jnp.float32, **kw)


def test_overlapped_stereo_node_matches_jax_node(params, sync_out,
                                                 monkeypatch):
    """overlap=1: call k returns frame k-1 under frame k-1's stamp, the
    same Nones and stamps as the JAX node's, the data within the
    tolerance of `test_stereo_node_matches_jax_node` and bit-equal to the
    port's own synchronous node (the same batch-1 forward)."""
    monkeypatch.delenv("REDTAIL_TPU_S2D", raising=False)  # JAX: raw stem
    frames = _frames(4)
    node = StereoNode(_spec(), params, dtype=torch.float32, device="cpu",
                      overlap=1)
    jnode = _jax_node(params, overlap=1)
    assert node.needs_stamp and jnode.needs_stamp
    for k, (left, right) in enumerate(frames):
        got = node(left, right, stamp=10.0 + k)
        want = jnode(left, right, stamp=10.0 + k)
        if k == 0:
            assert got is None and want is None
            continue
        assert isinstance(got, Stamped) and got.stamp == want.stamp
        assert got.stamp == 10.0 + k - 1
        np.testing.assert_array_equal(got.data, sync_out[k - 1])
        # raw 5x5 stem (JAX) against the s2d 3x3 stem (port): fp32 sums
        # reassociated, 1e-3 in sigmoid units, in pixels
        np.testing.assert_allclose(got.data, want.data, atol=1e-3 * HW[1])
    node.drain()
    jnode.drain()
    assert not node._inflight
    assert set(node.profiler.stats()) == {
        "stereo/resnet18_2d/pack", "stereo/resnet18_2d/dispatch",
        "stereo/resnet18_2d/upload", "stereo/resnet18_2d/enqueue",
        "stereo/resnet18_2d/fetch"}


def test_overlap_two_shifts_by_two(params, sync_out):
    node = StereoNode(_spec(), params, dtype=torch.float32, device="cpu",
                      overlap=2)
    outs = [node(l, r, stamp=float(k)) for k, (l, r) in
            enumerate(_frames(5))]
    assert outs[:2] == [None, None]
    assert [o.stamp for o in outs[2:]] == [0.0, 1.0, 2.0]
    for k, o in enumerate(outs[2:]):
        np.testing.assert_array_equal(o.data, sync_out[k])
    assert len(node._inflight) == 2
    node.close()
    assert not node._inflight


def test_microbatched_stereo_node_matches_jax_node(params, sync_out,
                                                   monkeypatch):
    """overlap=1, microbatch=2: two frames dispatch as one batch-2 forward
    and return as a list of per-frame `Stamped` results, at the calls and
    under the stamps the JAX node gives."""
    monkeypatch.delenv("REDTAIL_TPU_S2D", raising=False)
    frames = _frames(6)
    node = StereoNode(_spec(), params, dtype=torch.float32, device="cpu",
                      overlap=1, microbatch=2)
    jnode = _jax_node(params, overlap=1, microbatch=2)
    for k, (left, right) in enumerate(frames):
        got = node(left, right, stamp=float(k))
        want = jnode(left, right, stamp=float(k))
        if want is None:
            assert got is None
            continue
        assert isinstance(got, list) and len(got) == len(want) == 2
        assert [o.stamp for o in got] == [o.stamp for o in want]
        for o, w in zip(got, want):
            i = int(o.stamp)
            np.testing.assert_allclose(o.data, w.data, atol=1e-3 * HW[1])
            # batch 2 against batch 1: fp32 summation order, 1e-4 in
            # sigmoid units
            np.testing.assert_allclose(o.data, sync_out[i],
                                       atol=1e-4 * HW[1])
    assert [int(o.stamp) for o in got] == [2, 3]
    node.drain()
    jnode.drain()


def test_u16_wire_matches_jax_codes(params, sync_out, monkeypatch):
    """wire='u16': the codes round(disp * 64) equal JAX's, or differ by
    one where the two float disparities straddle a rounding boundary
    within their fp error; the port's u16 within 1/128 px of its f32."""
    monkeypatch.delenv("REDTAIL_TPU_S2D", raising=False)
    frames = _frames(3)
    node = StereoNode(_spec(), params, dtype=torch.float32, device="cpu",
                      wire="u16")
    jnode = _jax_node(params, wire="u16")
    jf32 = _jax_node(params)
    for k, (left, right) in enumerate(frames):
        got = node(left, right)
        assert got.dtype == np.float32 and got.shape == HW
        assert np.abs(got - sync_out[k]).max() <= 1.0 / 128.0 + 1e-6
        codes, jcodes = got * 64.0, jnode(left, right) * 64.0
        assert (codes == np.round(codes)).all()
        diff = np.abs(codes - jcodes)
        assert diff.max() <= 1
        # where they differ, the f32 disparities sit within their fp
        # difference of a rounding boundary
        boundary = np.abs(np.asarray(jf32(left, right)) * 64 % 1 - 0.5)
        assert (boundary[diff == 1] <= 64 * 1e-3 * HW[1]).all()


def test_u16_wire_rounds_and_saturates_as_jax(monkeypatch):
    """The quantization itself, on disparities chosen for it: round half
    to even, clip at 0 and at 65535 / 64 = 1023.984375 px, as
    `jnp.clip(jnp.round(d * 64), 0, 65535).astype(uint16)` does."""
    spec = dataclasses.replace(_spec(), input_hw=(2, 1))
    node = StereoNode(spec, init_stereo_params(_spec()), device="cpu",
                      dtype=torch.float32, wire="u16")
    px = np.array([0.0, 1.5 / 64, 2.5 / 64, 511.2, 1023.98, 1023.984375,
                   1023.99, 1500.0, 65535.0, -3.0, 0.6 / 64, 1024.0],
                  np.float32)
    node.net = lambda left, right: torch.from_numpy(px)[None]
    monkeypatch.setattr(node, "_upload",
                        lambda inputs: [torch.zeros(1), torch.zeros(1)])
    got = node._from_wire(node._run([(None, None)]).numpy()[0])
    want = np.clip(np.round(px.astype(np.float32) * 64), 0, 65535).astype(
        np.uint16).astype(np.float32) / 64.0
    np.testing.assert_array_equal(got, want)
    assert got[7] == got[8] == 65535 / 64 and got[9] == 0
    assert got[1] == 2 / 64 and got[2] == 2 / 64  # half to even


def test_warmup_and_drain_reset_the_pipeline(params):
    node = StereoNode(_spec(), params, dtype=torch.float32, device="cpu",
                      overlap=1, microbatch=2)
    dummy = np.zeros(HW + (3,), np.uint8)
    calls = []
    run = node._run
    node._run = lambda inputs: calls.append(len(inputs)) or run(inputs)
    node.warmup(dummy, dummy)
    assert calls == [2, 2]  # a full batch and a due result
    assert not node._inflight and not node._batch
    assert node(dummy, dummy, stamp=0.0) is None  # a fresh pipeline
    node.drain()
    sync = StereoNode(_spec(), params, dtype=torch.float32, device="cpu")
    sync.warmup(dummy, dummy)
    assert not sync.needs_stamp and not sync._inflight


def test_stereo_node_rules(params):
    spec = _spec()
    with pytest.raises(ValueError, match="overlap must be >= 0"):
        StereoNode(spec, params, device="cpu", overlap=-1)
    with pytest.raises(ValueError, match="microbatch requires overlap"):
        StereoNode(spec, params, device="cpu", overlap=0, microbatch=2)
    with pytest.raises(ValueError, match="unknown wire"):
        StereoNode(spec, params, device="cpu", wire="f16")
    node = StereoNode(spec, params, device="cpu", overlap=1, microbatch=2)
    two = np.zeros((2,) + HW + (3,), np.uint8)
    with pytest.raises(ValueError, match="one frame pair per call"):
        node(two, two, stamp=0.0)
    one = two[:1]
    assert node(one, one, stamp=0.0) is None  # a batch of one is a frame


def test_node_runs_in_inference_mode_on_a_graph_thread(params):
    """Grad mode is per thread: the node enters inference mode on the
    graph's thread, where the kernels' refusal of autograd would
    otherwise turn every frame into an error the node only counts."""
    node = StereoNode(_spec(), params, dtype=torch.float32, device="cpu",
                      overlap=1)
    modes = []
    handle = node.net.register_forward_pre_hook(
        lambda mod, args: modes.append((torch.is_inference_mode_enabled(),
                                        torch.is_grad_enabled())))
    g = NodeGraph()
    g.add_node("stereo", node, ["l", "r"], "disp", max_rate_hz=100,
               sync_slop=0.05)
    g.start()
    try:
        for k, (left, right) in enumerate(_frames(3)):
            stamp = 100.0 + k
            g.topic("l").publish(left, stamp=stamp)
            g.topic("r").publish(right, stamp=stamp)
            assert g.spin_until(lambda: len(modes) > k, timeout=WAIT)
        assert g.spin_until(lambda: g.topic("disp").count >= 2,
                            timeout=WAIT)
    finally:
        g.stop()
        handle.remove()
    assert modes and all(m == (True, False) for m in modes)
    assert g.nodes["stereo"].errors == 0
    # published under the true stamps of the frames they came from
    assert g.topic("disp").latest().stamp in (100.0, 101.0)


# --------------------------------------------- TrailNetNode and YoloNode

TINY_TRAILNET = """
input: "data"
input_shape { dim: 1 dim: 3 dim: 180 dim: 320 }
layer { name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
        convolution_param { num_output: 4 kernel_size: 5 stride: 4 pad: 2 } }
layer { name: "relu1" type: "ReLU" bottom: "conv1" top: "conv1" }
layer { name: "pool1" type: "Pooling" bottom: "conv1" top: "pool1"
        pooling_param { pool: AVE kernel_size: 9 stride: 9 } }
layer { name: "fc" type: "InnerProduct" bottom: "pool1" top: "fc"
        inner_product_param { num_output: 6 } }
layer { name: "prob" type: "Softmax" bottom: "fc" top: "prob" }
"""


def _caffe_pair(text, seed):
    return (CaffeNet(parse_prototxt(text), seed=seed, device="cpu"),
            JCaffeNet(jparse_prototxt(text), seed=seed))


@pytest.mark.parametrize("overlap,microbatch", [(0, 1), (1, 1), (1, 2)])
def test_trailnet_node_overlap_matches_jax(overlap, microbatch):
    """A TrailNet-shaped Caffe graph (180x320 -> 6), the same random draws
    in both packages: the same Nones, stamps and probabilities."""
    net, jnet = _caffe_pair(TINY_TRAILNET, 5)
    node = TrailNetNode(net, device="cpu", overlap=overlap,
                        microbatch=microbatch)
    jnode = jnodes.TrailNetNode(jnet, overlap=overlap, microbatch=microbatch)
    rs = np.random.RandomState(6)
    for k in range(5):
        frame = rs.randint(0, 256, (1, 180, 320, 3)).astype(np.uint8)
        got, want = node(frame, stamp=float(k)), jnode(frame, stamp=float(k))
        if overlap == 0:
            assert got.shape == (6,) and got.dtype == np.float32
            np.testing.assert_allclose(got, want, atol=1e-5)
            continue
        if want is None:
            assert got is None
            continue
        got, want = (x if isinstance(x, list) else [x] for x in (got, want))
        assert [o.stamp for o in got] == [o.stamp for o in want]
        for o, w in zip(got, want):
            np.testing.assert_allclose(o.data, w.data, atol=1e-5)
    with pytest.raises(ValueError, match="one frame per call"):
        node(np.zeros((2, 180, 320, 3), np.uint8), stamp=0.0)


@pytest.mark.parametrize("overlap", [0, 1])
def test_yolo_node_overlap_matches_jax(overlap):
    net, jnet = _caffe_pair(yolo_standin_prototxt(), 3)
    node = YoloNode(net, device="cpu", overlap=overlap, prob_threshold=0.01)
    jnode = jnodes.YoloNode(jnet, overlap=overlap, prob_threshold=0.01)
    rs = np.random.RandomState(7)
    for k in range(3):
        frame = rs.randint(0, 256, (448, 448, 3)).astype(np.uint8)
        got, want = node(frame, stamp=float(k)), jnode(frame, stamp=float(k))
        if want is None:
            assert got is None
            continue
        if overlap:
            assert got.stamp == want.stamp == k - 1
            got, want = got.data, want.data
        assert got.shape == want.shape and got.shape[1] == 6
        np.testing.assert_allclose(got, want, atol=1e-4)
    stages = set(node.profiler.stats())
    assert stages == ({"yolo/dnn", "yolo/postproc"} if not overlap else
                      {"yolo/dispatch", "yolo/fetch", "yolo/postproc"})
    with pytest.raises(ValueError, match="one frame per call"):
        node(np.zeros((2, 448, 448, 3), np.uint8))


def test_tap_stage_unwraps_and_forwards_needs_stamp():
    class FakeNode:
        needs_stamp = True

        def __init__(self):
            self.calls = []

        def __call__(self, frame, stamp=None):
            self.calls.append(stamp)
            return {"none": None, "plain": "result",
                    "one": Stamped("r1", 1.0)}.get(
                frame, [Stamped("r2", 2.0), Stamped("r3", 3.0)])

    node, seen = FakeNode(), []
    stage = tap_stage(node, seen.append)
    assert stage.needs_stamp is True
    assert stage("none", stamp=0.5) is None
    assert seen == [] and node.calls == [0.5]
    assert stage("plain", stamp=0.6) == "result"
    assert stage("one", stamp=0.7).stamp == 1.0
    assert [o.stamp for o in stage("burst", stamp=0.8)] == [2.0, 3.0]
    assert seen == ["result", "r1", "r2", "r3"]

    class SyncNode:
        needs_stamp = False

        def __call__(self, frame):  # must not be passed a stamp
            return "sync"

    sync = tap_stage(SyncNode(), seen.append)
    assert sync.needs_stamp is False and sync("f") == "sync"
    assert seen[-1] == "sync"


def test_tap_stage_publishes_microbatch_under_true_stamps():
    """A tapped microbatched node in a graph: every result reaches the
    tap and the topic's history, each under its own frame's stamp."""
    net, _ = _caffe_pair(TINY_TRAILNET, 5)
    node = TrailNetNode(net, device="cpu", overlap=1, microbatch=2)
    tapped = []
    stage = tap_stage(node, tapped.append)
    src, dst = Topic("cam"), Topic("out", history=8)
    graph_node = Node("trailnet", stage, [src], dst, max_rate_hz=1000)
    rs = np.random.RandomState(8)
    for k in range(6):
        src.publish(rs.randint(0, 256, (180, 320, 3)).astype(np.uint8),
                    stamp=50.0 + k)
        graph_node.step_once()
    assert [m.stamp for m in dst.take_since(0)] == [50.0, 51.0, 52.0, 53.0]
    assert len(tapped) == 4 and all(p.shape == (6,) for p in tapped)


def _caffe_nodes(kind):
    """(port node, JAX node, a frame not at the net's size) for ``kind``."""
    if kind == "trailnet":
        net, jnet = _caffe_pair(TINY_TRAILNET, 5)
        return (TrailNetNode(net, device="cpu"), jnodes.TrailNetNode(jnet),
                (90, 160, 3))
    net, jnet = _caffe_pair(yolo_standin_prototxt(), 3)
    return (YoloNode(net, device="cpu", prob_threshold=0.01),
            jnodes.YoloNode(jnet, prob_threshold=0.01), (300, 400, 3))


@pytest.mark.parametrize("kind", ["trailnet", "yolo"])
def test_caffe_nodes_resize_on_the_host_as_jax(kind):
    """A camera frame not at the net's size: both packages resize it on
    the host with cv2's INTER_CUBIC before the net, so the port's result
    equals the JAX node's (YOLO's boxes in the frame's own pixels)."""
    pytest.importorskip("cv2")
    node, jnode, shape = _caffe_nodes(kind)
    frame = np.random.RandomState(9).randint(0, 256, shape).astype(np.uint8)
    got, want = node(frame), jnode(frame)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("kind", ["trailnet", "yolo"])
def test_caffe_nodes_need_cv2_for_another_size(kind, monkeypatch):
    """Without cv2 a frame at the net's size serves and a frame of another
    size raises, in both packages: neither resizes on the device."""
    node, jnode, shape = _caffe_nodes(kind)
    monkeypatch.setitem(sys.modules, "cv2", None)
    at_size = np.zeros(tuple(node._hw) + (3,), np.uint8)
    np.testing.assert_allclose(node(at_size), jnode(at_size), atol=1e-4)
    for n in (node, jnode):
        with pytest.raises(ImportError):
            n(np.zeros(shape, np.uint8))
