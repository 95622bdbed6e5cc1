"""The port's applications and on-device ingest on the CPU against the JAX
package's: `apps/sim_app.py` (the trail world, the camera renderer, the
closed loop with the analytic classifier and with the real TrailNet),
`ops/preprocess.py:fused_ingest`, and `apps/pipeline_app.py` run for a
couple of seconds at 64x128 (its stereo spec cut in `STEREO_SPECS`)."""

import dataclasses
import json
import math
import time
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from redtail_tpu.apps import pipeline_app as jpipeline_app
from redtail_tpu.apps import sim_app as jsim
from redtail_tpu.ops.preprocess import fused_ingest as jfused_ingest

from redtail_tpu_torch.apps import pipeline_app, sim_app
from redtail_tpu_torch.models import (
    STEREO_SPECS,
    emit_trailnet_prototxt,
)
from redtail_tpu_torch.ops.preprocess import fused_ingest
from test_torch_caffe import yolo_standin_prototxt


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """A few intra-op threads, so that parallel test workers do not
    oversubscribe the cores (restored after)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, 2))
    yield
    torch.set_num_threads(saved)

# ---------------------------------------------------------- fused ingest


@pytest.mark.parametrize("src,dst", [
    ((2, 40, 60, 3), (40, 60)),      # no resize
    ((2, 40, 60, 3), (80, 120)),     # 2x up
    ((1, 40, 60, 3), (97, 131)),     # up, ragged ratio
    ((2, 40, 60, 3), (20, 30)),      # 2x down: the kernel widens
    ((1, 41, 63, 3), (17, 29)),      # down, ragged ratio
    ((1, 90, 160, 3), (180, 320)),   # a camera frame up to TrailNet's size
    ((1, 321, 1025, 3), (180, 320)),  # and down
    ((40, 60, 3), (30, 50)),         # one unbatched frame
], ids=str)
def test_fused_ingest_matches_jax(src, dst):
    """`F.interpolate(bilinear, antialias=True)` against
    `jax.image.resize(bilinear)`: half-pixel centres, clamped edges and
    the widened triangle kernel alike; measured max 1.8e-6 on [0, 1]
    outputs, in the interior and at the edges alike (float32 weights)."""
    x = np.random.RandomState(sum(src)).randint(0, 256, src).astype(np.uint8)
    want = np.asarray(jfused_ingest(jnp.asarray(x), dst))
    got = fused_ingest(x, dst, device="cpu")
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    # no systematic edge difference: the border rows and columns hold to
    # the same bound as the interior
    edge = np.abs(got.numpy() - want)[:, [0, -1]]
    assert edge.max() <= 1e-5


def test_fused_ingest_options_match_jax():
    x = np.random.RandomState(1).randint(0, 256, (2, 30, 50, 3)).astype(
        np.uint8)
    kw = dict(bgr_to_rgb=False, scale=1.0, shift=-128.0)
    want = np.asarray(jfused_ingest(jnp.asarray(x), (24, 40), **kw))
    got = fused_ingest(torch.from_numpy(x), (24, 40), **kw)
    # 0..255 outputs: the same float32 weight rounding, times 255
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=255e-5)
    np.testing.assert_array_equal(
        fused_ingest(torch.from_numpy(x), (30, 50)).numpy(),
        x[..., ::-1].astype(np.float32) * np.float32(1.0 / 255.0))


# ------------------------------------------------------------ sim_app


def test_render_trail_view_matches_jax():
    trail, jtrail = sim_app.Trail(), jsim.Trail()
    for i, (x, y, yaw) in enumerate([(0.0, 0.0, 0.0), (13.0, 2.5, 0.4),
                                     (77.0, -6.0, -1.2)]):
        got = sim_app.render_trail_view(trail, x, y, yaw,
                                        rng=np.random.RandomState(i))
        want = jsim.render_trail_view(jtrail, x, y, yaw,
                                      rng=np.random.RandomState(i))
        assert got.shape == (180, 320, 3) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_virtual_sim_matches_jax():
    """The analytic classifier's closed loop: the same float64 numpy
    controller and world on both sides, equal to the last bit."""
    got = sim_app.run_sim(300, seed=3)
    want = jsim.run_sim(300, seed=3)
    assert got == want and got["max_cross_track"] < 5.0


def _recording(classify, poses, probs):
    def f(pose, rng):
        poses.append(np.array(pose.position))
        p = classify(pose, rng)
        probs.append(p)
        return p
    return f


@pytest.fixture(scope="module")
def classifiers():
    return (sim_app.make_real_trailnet(device="cpu"),
            jsim.make_real_trailnet())


def test_real_dnn_sim_closed_loop_matches_jax(classifiers):
    """`run_sim` with the real TrailNet in the loop, 25 steps: the
    cross-track series within 1e-4 m of JAX's. Each frame's probabilities
    agree to ~1e-6; the loop feeds them back through the controller into
    the camera pose, and the renderer's trail edge and world texture turn
    a pose difference of ~1e-5 m into flipped pixels, so the two runs part
    by ~1e-3 m after ~30 steps (measured: 2.1e-5 m at step 26, 9.6e-4 m
    at step 38); the open-loop test below holds all 50 steps."""
    series = {}
    for name, classify, mod in (("port", classifiers[0], sim_app),
                                ("jax", classifiers[1], jsim)):
        poses, probs = [], []
        res = mod.run_sim(25, classifier=_recording(classify, poses, probs))
        trail = mod.Trail()
        series[name] = (np.array([trail.cross_track(p[0], p[1])
                                  for p in poses]), np.array(probs), res)
    np.testing.assert_allclose(series["port"][0], series["jax"][0],
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(series["port"][1], series["jax"][1],
                               rtol=0, atol=1e-5)
    assert series["port"][2]["dnn_commands"] == 25


def test_real_dnn_open_loop_matches_jax(classifiers):
    """The port's TrailNet on JAX's own 50 closed-loop poses, with the
    same camera noise drawn in the same order: the six probabilities
    within 1e-5 of JAX's at every step."""
    from redtail_tpu_torch.control import Pose

    poses, want = [], []

    def record(pose, rng):
        poses.append((np.array(pose.position), np.array(pose.orientation)))
        want.append(classifiers[1](pose, rng))
        return want[-1]
    jsim.run_sim(50, seed=0, classifier=record)
    rng = np.random.RandomState(0)  # run_sim's, drawn only by the renderer
    got = [classifiers[0](Pose(p, q), rng) for p, q in poses]
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=0,
                               atol=1e-5)


def test_sim_app_main_real_dnn(capsys):
    assert sim_app.main(["--real-dnn", "--cpu", "--steps", "8"]) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["real_dnn"] is True and result["dnn_commands"] == 8


# --------------------------------------------------------- pipeline_app


@pytest.fixture
def small_pipeline(monkeypatch, tmp_path):
    """ResNet18-2D cut to 64x128, max_disp 8, in the port's spec table;
    the emitted TrailNet prototxt and a YOLO-shaped stand-in on disk."""
    monkeypatch.setitem(STEREO_SPECS, "resnet18_2d", dataclasses.replace(
        STEREO_SPECS["resnet18_2d"], input_hw=(64, 128), max_disp=8))
    (tmp_path / "trailnet.prototxt").write_text(emit_trailnet_prototxt())
    (tmp_path / "yolo.prototxt").write_text(yolo_standin_prototxt())
    return tmp_path


def _summary(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_pipeline_app_runs_on_the_cpu(small_pipeline, capsys):
    pipeline_app.main([
        "--cpu", "--duration", "2.7",
        "--trailnet-prototxt", str(small_pipeline / "trailnet.prototxt"),
        "--yolo-prototxt", str(small_pipeline / "yolo.prototxt"),
        # half-way between YOLO's 1 Hz publishes, which would overwrite
        # the injected person on the latest-wins topic
        "--fcu", "mavlink", "--demo-person-stop", "1.5"])
    s = _summary(capsys)
    assert s["frames"]["stereo"] > 0 and s["frames"]["controller"] > 0, s
    assert s["frames"]["trailnet"] > 0, s
    assert set(s["errors"]) == {"stereo", "trailnet", "yolo", "objstop",
                                "controller"}
    assert not any(s["errors"].values()), s["errors"]
    assert s["stop_events"] >= 1, s
    assert s["mavlink"]["armed"] and s["mavlink"]["bad_crc"] == 0


def _stop_after_control_steps(monkeypatch, steps):
    """End `pipeline_app.main`'s run once its controller node has stepped
    ``steps`` times: from then on the app's clock reads +inf, so its loop
    ends at the next check, whatever ``--duration`` is."""
    from redtail_tpu_torch import runtime

    graphs = []

    class RecordingGraph(runtime.NodeGraph):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            graphs.append(self)

    def monotonic():
        control = graphs[-1].nodes.get("controller") if graphs else None
        if control is not None and control.processed >= steps:
            return math.inf
        return time.monotonic()

    monkeypatch.setattr(runtime, "NodeGraph", RecordingGraph)
    monkeypatch.setattr(pipeline_app, "time", types.SimpleNamespace(
        monotonic=monotonic, sleep=time.sleep))


def test_pipeline_app_microbatch_and_u16_wire(small_pipeline, capsys,
                                              monkeypatch):
    """Two control steps bound the run, not the clock: on a loaded host a
    batch of two frames on the CPU can take longer than a fixed duration.
    The controller steps once for each new disparity it takes, so it has
    stepped twice only after two frames were published; ``--duration``
    only caps the run."""
    _stop_after_control_steps(monkeypatch, 2)
    pipeline_app.main(["--cpu", "--duration", "60", "--overlap", "1",
                       "--microbatch", "2", "--wire", "u16",
                       "--yolo-rate", "0"])
    s = _summary(capsys)
    assert s["frames"]["stereo"] >= 2 and s["frames"]["controller"] >= 2, s
    assert not any(s["errors"].values()), s["errors"]
    assert set(s["frames"]) == {"stereo", "controller"}


def _options(parser):
    return {s for action in parser._actions for s in action.option_strings}


def test_pipeline_app_flags_and_rejections():
    assert _options(pipeline_app.build_argparser()) == \
        _options(jpipeline_app.build_argparser()) | {"--cpu"}
    args = pipeline_app.build_argparser().parse_args(
        ["--overlap", "2", "--microbatch", "3", "--wire", "u16", "--cpu"])
    assert (args.overlap, args.microbatch, args.wire, args.cpu) == \
        (2, 3, "u16", True)
    defaults = pipeline_app.build_argparser().parse_args([])
    assert (defaults.overlap, defaults.microbatch, defaults.wire,
            defaults.fcu, defaults.stereo_model) == \
        (1, 1, "f32", "sim", "resnet18_2d")
    with pytest.raises(SystemExit, match="together"):
        pipeline_app.main(["--video-left", "l.avi", "--duration", "0.1"])
    # the flag reads a TF checkpoint's index (tests/test_torch_weights_io.py
    # serves a real one); a missing one is a missing file
    with pytest.raises(FileNotFoundError, match="ckpt.index"):
        pipeline_app.main(["--stereo-checkpoint", "ckpt", "--cpu"])
    assert pipeline_app._default_yolo_prototxt() is None
