"""The port's entry points (`StereoNode`, `stereo_app`) against the JAX
package's, on the CPU, plus the port's ground rules: weights carried across
exactly, the card by default, and no import of JAX or `redtail_tpu`."""

import ast
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from redtail_tpu.models import STEREO_SPECS as JSPECS
from redtail_tpu.runtime.nodes import StereoNode as JStereoNode
from redtail_tpu.utils.checkpoint import save_params

from redtail_tpu_torch.io import read_bin
from redtail_tpu_torch.models import (
    STEREO_SPECS,
    init_stereo_params,
    params_from_npz,
    params_from_numpy,
    params_to_numpy,
)
from redtail_tpu_torch.runtime import StereoNode
from test_torch_stereo import conditioned

ROOT = Path(__file__).resolve().parent.parent
HW = (65, 129)


def _spec():
    return dataclasses.replace(STEREO_SPECS["resnet18_2d"], input_hw=HW,
                               max_disp=8)


def _frames(seed=3):
    rs = np.random.RandomState(seed)
    return tuple(rs.randint(0, 256, HW + (3,)).astype(np.uint8)
                 for _ in range(2))


def test_stereo_node_matches_jax_node(monkeypatch):
    monkeypatch.delenv("REDTAIL_TPU_S2D", raising=False)  # JAX: raw stem
    spec = _spec()
    jspec = dataclasses.replace(JSPECS["resnet18_2d"], input_hw=HW,
                                max_disp=8)
    params = conditioned(init_stereo_params(spec, seed=1))
    left, right = _frames()
    want = JStereoNode(jspec, jax.tree.map(jnp.asarray, params),
                       dtype=jnp.float32)(left, right)
    node = StereoNode(spec, params, dtype=torch.float32, device="cpu")
    got = node(left, right)
    assert got.shape == HW and got.dtype == np.float32
    # Same frames and weights; JAX's CPU node takes the raw 5x5 stem and the
    # port the s2d 3x3 stem (reassociated fp32 sums), and the output is
    # sigmoid x width: 1e-3 in sigmoid units, in pixels.
    np.testing.assert_allclose(got, want, atol=1e-3 * HW[1])
    assert set(node.profiler.stats()) == {
        "stereo/resnet18_2d", "stereo/resnet18_2d/pack",
        "stereo/resnet18_2d/upload", "stereo/resnet18_2d/enqueue"}


def test_stereo_node_3d_model_serves_pixels(monkeypatch):
    """The 3D models return pixels already: the node must not scale them
    by the width as it does the correlation model's sigmoid output."""
    monkeypatch.delenv("REDTAIL_TPU_S2D", raising=False)  # JAX: raw stem
    monkeypatch.setenv("REDTAIL_TPU_PACKED3D", "0")       # JAX: unpacked 3D
    spec = dataclasses.replace(STEREO_SPECS["nvtiny"], input_hw=HW,
                               max_disp=8)
    jspec = dataclasses.replace(JSPECS["nvtiny"], input_hw=HW, max_disp=8)
    params = conditioned(init_stereo_params(spec, seed=1))
    left, right = _frames()
    want = JStereoNode(jspec, jax.tree.map(jnp.asarray, params),
                       dtype=jnp.float32)(left, right)
    got = StereoNode(spec, params, dtype=torch.float32, device="cpu")(
        left, right)
    assert got.shape == HW and got.dtype == np.float32
    assert 0 <= got.min() and got.max() <= spec.full_max_disp
    # raw 5x5 stem (JAX) against the s2d 3x3 stem (port): reassociated fp32
    # sums through the net and the soft-argmin, in pixels
    np.testing.assert_allclose(got, want, atol=1e-3)


@pytest.mark.parametrize("kwargs,error,match", [
    pytest.param(kwargs, error, match, id=str(kwargs))
    for kwargs, error, match in (
        ({"quantize": "int8"}, ValueError, "requires calib_frames"),
        ({"device": "cuda:1"}, RuntimeError, "cuda:1: only 1 card"))])
def test_stereo_node_later_slices_raise(kwargs, error, match, monkeypatch):
    """A stage pins to any card that is there (`device="cuda:k"`); a card
    that is not there raises (one card here: CUDA faked available, the
    check comes before any allocation). The quantized rungs serve
    (`tests/test_torch_quant.py`), and int8 without calibration frames
    raises as in the JAX node."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    spec = _spec()
    kwargs.setdefault("device", "cpu")
    with pytest.raises(error, match=match):
        StereoNode(spec, init_stereo_params(spec), **kwargs)


def test_stereo_node_rejects_batches():
    spec = _spec()
    node = StereoNode(spec, init_stereo_params(spec), dtype=torch.float32,
                      device="cpu")
    left, right = _frames()
    with pytest.raises(ValueError, match="one frame pair per call"):
        node(np.stack([left, left]), np.stack([right, right]))


def test_stereo_app_matches_jax_app(tmp_path, capsys):
    cv2 = pytest.importorskip("cv2")
    from redtail_tpu.apps import stereo_app as japp

    from redtail_tpu_torch.apps import stereo_app

    spec = _spec()
    save_params(jax.tree.map(jnp.asarray,
                             conditioned(init_stereo_params(spec, seed=2))),
                tmp_path / "w.npz")
    big = np.random.RandomState(4).randint(0, 256, (100, 200, 3)).astype(
        np.uint8)
    cv2.imwrite(str(tmp_path / "l.png"), big)
    cv2.imwrite(str(tmp_path / "r.png"), np.roll(big, 3, axis=1))
    common = ["resnet18_2d", "--cpu", "--hw", *map(str, HW), "--weights",
              str(tmp_path / "w.npz"), "--left", str(tmp_path / "l.png"),
              "--right", str(tmp_path / "r.png")]
    japp.main(common + ["--out", str(tmp_path / "jax"), "--no-cache"])
    stereo_app.main(common + ["--out", str(tmp_path / "port"), "--profile"])
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()
             if s.startswith("{")]
    assert lines[0].keys() == lines[1].keys()
    assert lines[1]["shape"] == list(HW)
    want = read_bin(tmp_path / "jax.bin")
    got = read_bin(tmp_path / "port.bin")
    assert got.shape == want.shape == HW
    # same preprocessing and raw stem on both sides: fp32 summation order,
    # in sigmoid units (as tests/test_torch_stereo.py)
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert cv2.imread(str(tmp_path / "port.png"),
                      cv2.IMREAD_UNCHANGED).dtype == np.uint16


def test_stereo_app_3d_model_matches_jax_app(tmp_path, capsys,
                                             monkeypatch):
    cv2 = pytest.importorskip("cv2")
    from redtail_tpu.apps import stereo_app as japp

    from redtail_tpu_torch.apps import stereo_app

    monkeypatch.setenv("REDTAIL_TPU_PACKED3D", "0")
    spec = STEREO_SPECS["nvtiny"]
    save_params(jax.tree.map(jnp.asarray,
                             conditioned(init_stereo_params(spec, seed=2))),
                tmp_path / "w.npz")
    big = np.random.RandomState(5).randint(0, 256, (100, 200, 3)).astype(
        np.uint8)
    cv2.imwrite(str(tmp_path / "l.png"), big)
    cv2.imwrite(str(tmp_path / "r.png"), np.roll(big, 3, axis=1))
    common = ["nvtiny", "--cpu", "--hw", *map(str, HW), "--weights",
              str(tmp_path / "w.npz"), "--left", str(tmp_path / "l.png"),
              "--right", str(tmp_path / "r.png")]
    japp.main(common + ["--out", str(tmp_path / "jax"), "--no-cache"])
    stereo_app.main(common + ["--out", str(tmp_path / "port")])
    capsys.readouterr()
    want = read_bin(tmp_path / "jax.bin")
    got = read_bin(tmp_path / "port.bin")
    assert got.shape == want.shape == HW
    # same preprocessing and raw stem on both sides: fp32 summation order,
    # in pixels (as tests/test_torch_stereo3d.py)
    np.testing.assert_allclose(got, want, atol=1e-3)
    png = cv2.imread(str(tmp_path / "port.png"), cv2.IMREAD_UNCHANGED)
    # the 3D models' PNG is pixels x 256 (`main.cpp:325-327`)
    np.testing.assert_array_equal(
        png, np.clip(got * 256.0, 0, 65535).astype(np.uint16))


def test_params_from_npz_bf16_round_trip(tmp_path):
    """A bf16 JAX checkpoint (`@bf16` leaves) loads without ml_dtypes and
    carries every weight across exactly."""
    spec = _spec()
    params = conditioned(init_stereo_params(spec, seed=3))
    bf16 = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    save_params(bf16, tmp_path / "w16.npz")
    assert any(k.endswith("@bf16") for k in np.load(tmp_path / "w16.npz"))
    loaded = params_from_npz(tmp_path / "w16.npz")
    exact = jax.tree.map(lambda a: np.asarray(a, np.float32), bf16)
    jax.tree.map(np.testing.assert_array_equal, loaded, exact)
    net = params_from_numpy(spec, loaded, device="cpu", dtype=torch.bfloat16)
    jax.tree.map(np.testing.assert_array_equal, params_to_numpy(net), exact)


def test_params_from_npz_golden_bundle_keys():
    """The golden bundles' `model|scope|layer|var` keys, 'disp' skipped."""
    tree = params_from_npz(ROOT / "tests/data/resnet18_golden.npz")
    assert "disp" not in tree
    assert tree["encoder2D"]["conv1"]["weights"].shape == (5, 5, 3, 32)


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from redtail_tpu_torch import resolve_device, seeded_generator
    from redtail_tpu_torch.apps import stereo_app
    from redtail_tpu_torch.io import parse_prototxt
    from redtail_tpu_torch.models import (CaffeNet, emit_trailnet_prototxt,
                                          init_trailnet_params)
    from redtail_tpu_torch.models import trailnet
    from redtail_tpu_torch.apps import (pipeline_app, sim_app,
                                        train_r18_synth, train_trailnet_synth)
    from redtail_tpu_torch.ops.preprocess import fused_ingest
    from redtail_tpu_torch.quant import calibrate_stereo
    from redtail_tpu_torch.runtime import TrailNetNode, YoloNode

    spec = _spec()
    params = init_stereo_params(spec)
    proto = parse_prototxt(emit_trailnet_prototxt())
    tree = init_trailnet_params()
    for call in (lambda: resolve_device(),
                 lambda: seeded_generator(0),
                 lambda: params_from_numpy(spec, params),
                 lambda: StereoNode(spec, params),
                 lambda: stereo_app.main(["resnet18_2d", "--left", "l.png",
                                          "--right", "r.png"]),
                 lambda: CaffeNet(proto),
                 lambda: trailnet.params_from_numpy(tree),
                 lambda: TrailNetNode(trailnet.params_from_numpy(
                     tree, device="cpu")),
                 lambda: YoloNode(CaffeNet(proto, device="cpu")),
                 lambda: StereoNode(spec, params, overlap=1),
                 lambda: StereoNode(spec, params, quantize="w8"),
                 lambda: calibrate_stereo(spec, params, []),
                 lambda: pipeline_app.main(["--duration", "0.1"]),
                 lambda: train_r18_synth.main([]),
                 lambda: train_trailnet_synth.main([]),
                 lambda: sim_app.make_real_trailnet(),
                 lambda: fused_ingest(np.zeros((4, 4, 3), np.uint8),
                                      (2, 2))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")
    assert torch.randn(2, generator=seeded_generator(1, "cpu")).shape == (2,)


def _port_files():
    pkg = ROOT / "redtail_tpu_torch"
    return sorted(p for p in pkg.rglob("*.py")
                  if p.relative_to(pkg).parts[0] != "build") + [
        ROOT / "chip_smoke.py"]


def test_port_scan_covers_the_weight_and_quant_modules():
    """The scan below walks every module of the package; these are the
    ones the weight loaders, the quantized rungs, the training slice, the
    layer profiler and engines and the multi-device slice (whose spawn
    targets, `parallel/rank_checks.py`, the ranks import afresh) added."""
    scanned = {str(p.relative_to(ROOT)) for p in _port_files()}
    for name in ("io/trt_weights.py", "io/tf_checkpoint.py",
                 "quant/ptq.py", "quant/stereo_int8.py",
                 "utils/metrics.py", "utils/checkpoint.py",
                 "utils/config.py", "utils/logging.py", "data/kitti.py",
                 "data/trails.py", "parallel/training.py",
                 "training/stereo.py", "training/trailnet.py",
                 "apps/train_app.py", "kernels/_ops.py",
                 "runtime/layer_profiler.py", "runtime/cache.py",
                 "runtime/engine_builder.py", "parallel/launch.py",
                 "ops/halo.py", "parallel/sharding.py",
                 "parallel/rank_checks.py", "ops/packed2d.py",
                 "apps/convert_model.py", "apps/eval_disparity.py",
                 "apps/train_r18_synth.py", "apps/train_trailnet_synth.py"):
        assert f"redtail_tpu_torch/{name}" in scanned


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "redtail_tpu"), (
                f"{path.name}:{node.lineno} imports {name}")
