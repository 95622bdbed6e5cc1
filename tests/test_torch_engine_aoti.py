"""Serialized engines on the CPU (`runtime/cache.py`,
`runtime/engine_builder.py`, `stereo_app --save-engine / --engine`): the
one test file that compiles with AOTInductor (each compile takes tens of
seconds on a CPU), mirroring the JAX package's `tests/test_runtime.py`
engine tests.

- `enable_compilation_cache` plus `aot_compile` of a tiny module;
- `build_stereo_engine` of ResNet18-2D at 32x64, max_disp 4, fp32, on the
  CPU, in its pristine subprocess (built once for the module); a fresh
  process loads it without importing any model code and matches the eager
  model within 1e-4 (fp32 summation order), which matches JAX
  `stereo_forward` within 1e-4 (the slice's tolerance);
- `stereo_app --engine` runs that engine and writes the eager model's
  disparity; `stereo_app --save-engine` then `--engine` write the same
  `.bin` within 1e-4, and the JSON line names the engine.

Weights are the port's seeded init conditioned as `tests/test_torch_stereo`
conditions them (random biases, a volume of O(1)).
"""

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from redtail_tpu.models import STEREO_SPECS as JSPECS
from redtail_tpu.models import stereo as jstereo

from redtail_tpu_torch.apps import stereo_app
from redtail_tpu_torch.io import read_bin
from redtail_tpu_torch.models import (STEREO_SPECS, init_stereo_params,
                                      params_from_numpy)
from redtail_tpu_torch.ops.space_to_depth import space_to_depth2_np
from redtail_tpu_torch.runtime import cache
from redtail_tpu_torch.runtime.engine_builder import build_stereo_engine
from redtail_tpu_torch.utils.checkpoint import save_params
from test_torch_stereo import conditioned

ROOT = Path(__file__).resolve().parent.parent
HW, MAX_DISP = (32, 64), 4


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """A few intra-op threads, so that parallel test workers do not
    oversubscribe the cores (restored after)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, 2))
    yield
    torch.set_num_threads(saved)


def _pair(hw, seed=2):
    """A random-texture uint8 BGR pair, the right frame shifted."""
    frame = np.random.RandomState(seed).randint(0, 256, (*hw, 3)).astype(
        np.uint8)
    return frame, np.roll(frame, -2, axis=1)


@pytest.fixture(scope="module")
def engine(tmp_path_factory):
    """ResNet18-2D built once by the pristine builder: (path, spec, tree,
    build seconds)."""
    spec = dataclasses.replace(STEREO_SPECS["resnet18_2d"], input_hw=HW,
                               max_disp=MAX_DISP)
    tree = conditioned(init_stereo_params(spec, seed=0))
    path = tmp_path_factory.mktemp("engine") / "resnet18_2d.pt2"
    t0 = time.perf_counter()
    build_stereo_engine(path, spec, tree, (1, HW[0] // 2, HW[1] // 2, 12),
                        dtype="fp32", cpu=True, timeout=600)
    return path, spec, tree, time.perf_counter() - t0


def _s2d_frames(frames):
    """The pair as the app preprocesses it (RGB in [0, 1]) and the node
    packs it."""
    return [space_to_depth2_np(f[None, ..., ::-1].astype(np.float32) / 255.0)
            for f in frames]


def test_aot_compile_with_the_cache(tmp_path, monkeypatch):
    monkeypatch.delenv("TORCHINDUCTOR_CACHE_DIR", raising=False)
    import torch._inductor.config as inductor_config
    monkeypatch.setattr(inductor_config, "fx_graph_cache",
                        inductor_config.fx_graph_cache)
    cache_dir = cache.enable_compilation_cache(str(tmp_path / "cache"),
                                               device="cpu")

    class Tiny(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.randn(4, 3, 3, 3),
                                        requires_grad=False)

        def forward(self, x):
            return torch.relu(torch.nn.functional.conv2d(x, self.w,
                                                         padding=1)) * 2

    module, x = Tiny(), torch.randn(1, 3, 8, 8)
    run = cache.aot_compile(module, x)
    torch.testing.assert_close(run(x), module(x), rtol=0, atol=1e-5)
    assert any(Path(cache_dir).iterdir())


def test_fresh_process_loads_the_engine_without_model_code(engine,
                                                           tmp_path):
    path, spec, tree, build_s = engine
    meta = cache.read_sidecar(path)
    assert meta["device"] == "cpu" and meta["extras"]["model"] == \
        "resnet18_2d"
    assert meta["ops"] == ["redtail_torch.corr_cost_volume.default"]
    left, right = _s2d_frames(_pair(HW))
    np.save(tmp_path / "left.npy", left)
    np.save(tmp_path / "right.npy", right)
    script = (
        "import sys, time, json, numpy as np, torch\n"
        "from redtail_tpu_torch.runtime.cache import load_engine\n"
        "t0 = time.perf_counter()\n"
        f"call, extras = load_engine({str(path)!r}, device='cpu')\n"
        "load_ms = 1e3 * (time.perf_counter() - t0)\n"
        f"l, r = (torch.from_numpy(np.load({str(tmp_path)!r} + f'/{{s}}.npy'))"
        " for s in ('left', 'right'))\n"
        f"np.save({str(tmp_path / 'out.npy')!r}, call(l, r).numpy())\n"
        "print(json.dumps({'load_ms': load_ms, 'models': sorted(m for m in "
        "sys.modules if m.startswith('redtail_tpu_torch.models'))}))\n")
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"engine build {build_s:.1f} s; fresh-process load "
          f"{report['load_ms']:.0f} ms")
    assert report["models"] == []
    got = np.load(tmp_path / "out.npy")

    net = params_from_numpy(spec, tree, device="cpu")
    with torch.inference_mode():
        eager = net(torch.from_numpy(left), torch.from_numpy(right)).numpy()
    np.testing.assert_allclose(got, eager, atol=1e-4)
    jspec = dataclasses.replace(JSPECS["resnet18_2d"], input_hw=HW,
                                max_disp=MAX_DISP)
    want = np.asarray(jstereo.stereo_forward(
        jspec, jax.tree.map(jnp.asarray, tree), jnp.asarray(left),
        jnp.asarray(right)), np.float32)
    np.testing.assert_allclose(eager, want, atol=1e-4)


def _app_args(tmp_path, frames, *extra):
    import cv2

    for name, frame in zip(("l", "r"), frames):
        cv2.imwrite(str(tmp_path / f"{name}.png"), frame)
    return ["resnet18_2d", "--cpu", "--left", str(tmp_path / "l.png"),
            "--right", str(tmp_path / "r.png"), *extra]


def _json_lines(capsys):
    return [json.loads(s) for s in capsys.readouterr().out.splitlines()
            if s.startswith("{")]


def test_stereo_app_runs_the_engine(engine, tmp_path, capsys):
    pytest.importorskip("cv2")
    path, spec, tree, _ = engine
    frames = _pair(HW)
    stereo_app.main(_app_args(tmp_path, frames, "--no-cache", "--engine",
                              str(path), "--out", str(tmp_path / "eng")))
    line = _json_lines(capsys)[-1]
    assert line["engine"] == str(path) and line["shape"] == list(HW)
    left, right = _s2d_frames(frames)
    net = params_from_numpy(spec, tree, device="cpu")
    with torch.inference_mode():
        eager = net(torch.from_numpy(left), torch.from_numpy(right)).numpy()
    np.testing.assert_allclose(read_bin(tmp_path / "eng.bin"), eager[0],
                               atol=1e-4)


@pytest.mark.slow
def test_stereo_app_save_engine_then_engine(tmp_path, capsys):
    """The app's own build: the eager pass on raw frames and the engine on
    the s2d frames it serves write the same disparity. Marked slow: the
    file's heaviest case (a second AOTInductor build, 48.6 s under six
    test workers); `chip_smoke.py` phase 10b runs `--save-engine` then
    `--engine` on the card."""
    pytest.importorskip("cv2")
    spec = dataclasses.replace(STEREO_SPECS["resnet18_2d"], input_hw=HW)
    save_params(conditioned(init_stereo_params(spec, seed=3)),
                tmp_path / "w.npz")
    args = _app_args(tmp_path, _pair(HW, seed=5), "--no-cache", "--weights",
                     str(tmp_path / "w.npz"))
    path = str(tmp_path / "app.pt2")
    stereo_app.main(args + ["--hw", *map(str, HW), "--save-engine", path,
                            "--out", str(tmp_path / "eager")])
    stereo_app.main(args + ["--engine", path, "--out",
                            str(tmp_path / "eng")])
    lines = _json_lines(capsys)
    assert "engine" not in lines[0] and lines[1]["engine"] == path
    np.testing.assert_allclose(read_bin(tmp_path / "eng.bin"),
                               read_bin(tmp_path / "eager.bin"), atol=1e-4)
    assert cache.read_sidecar(path)["extras"]["input_shape"] == [
        1, HW[0] // 2, HW[1] // 2, 12]
