"""The quantized stereo rungs at the entry points against the JAX
package's, on the CPU: `StereoNode(quantize="w8" | "int8")` and
`stereo_app --quantize int8 --accuracy`. Inputs are seeded numpy arrays
fed to both packages; each tolerance is stated with its reason."""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from redtail_tpu.models import STEREO_SPECS as JSPECS
from redtail_tpu.runtime.nodes import StereoNode as JStereoNode

from redtail_tpu_torch.models import STEREO_SPECS, init_stereo_params
from redtail_tpu_torch.models.stereo import _Int8Conv
from redtail_tpu_torch.runtime import StereoNode
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


# ---------------------------------------------------------- serving node


def _u8_pairs(count, hw=HW, seed=3):
    rs = np.random.RandomState(seed)
    return [tuple(rs.randint(0, 256, hw + (3,)).astype(np.uint8)
                  for _ in range(2)) for _ in range(count)]


@pytest.mark.parametrize("quantize", ["w8", "int8"])
def test_stereo_node_quantized_matches_jax_node(monkeypatch, quantize):
    """fp32 nodes of both packages on the same frames and calibration
    pairs (one of them at another size: resized bilinearly on both
    sides). The port's int8 node uploads raw RGB frames (no s2d pack).
    Gate: 1e-3 sigmoid units in pixels, the fp32 node gate of
    tests/test_torch_serving.py; int8 inputs that land within fp32 noise of
    a rounding boundary may take the other step, so the int8 gate also
    allows a mean of 1e-3 px beyond it on a few pixels."""
    monkeypatch.delenv("REDTAIL_TPU_S2D", raising=False)  # JAX: raw stem
    spec, jspec = _specs("resnet18_2d")
    params = conditioned(init_stereo_params(spec, seed=1))
    calib = _u8_pairs(1, seed=4) + _u8_pairs(1, hw=(40, 70), seed=5)
    kw = {"calib_frames": calib} if quantize == "int8" else {}
    left, right = _u8_pairs(1)[0]
    want = JStereoNode(jspec, jax.tree.map(jnp.asarray, params),
                       dtype=jnp.float32, quantize=quantize, **kw)(left,
                                                                   right)
    node = StereoNode(spec, params, dtype=torch.float32, device="cpu",
                      quantize=quantize, **kw)
    assert node._s2d == (quantize != "int8")
    got = node(left, right)
    assert got.shape == HW and got.dtype == np.float32
    err = np.abs(got - want)
    assert err.mean() < 1e-3 * HW[1] and np.median(err) < 1e-3 * HW[1]
    assert isinstance(node.net.encoder2D.conv1, _Int8Conv) == \
        (quantize == "int8")
    with pytest.raises(ValueError, match="unknown quantize"):
        StereoNode(spec, params, device="cpu", quantize="fp8")


def test_stereo_node_int8_bf16_serves():
    spec, _ = _specs("nvtiny")
    params = conditioned(init_stereo_params(spec, seed=1))
    node = StereoNode(spec, params, dtype=torch.bfloat16, device="cpu",
                      quantize="int8", calib_frames=_u8_pairs(1))
    ref = StereoNode(spec, params, dtype=torch.float32, device="cpu")
    frame = _u8_pairs(1, seed=6)[0]
    got, want = node(*frame), ref(*frame)
    assert got.shape == HW and np.isfinite(got).all()
    # int8 activations and bf16 against fp32: the bf16 gate, 0.1 px mean
    assert np.abs(got - want).mean() < 0.1


# ------------------------------------------------------------ stereo_app


def test_stereo_app_quantize_and_accuracy_match_jax(tmp_path, capsys,
                                                    monkeypatch):
    """`--quantize int8 --accuracy` on both apps, NVTiny bf16: the same
    five rungs; the fp32 row equal within fp32 noise, the bf16 rows within
    the bf16 gate in EPE; and the served disparity of each app within
    0.1 px mean."""
    cv2 = pytest.importorskip("cv2")
    from redtail_tpu.apps import stereo_app as japp

    from redtail_tpu_torch.apps import stereo_app
    from redtail_tpu_torch.io import read_bin
    from redtail_tpu.utils.checkpoint import save_params

    monkeypatch.delenv("REDTAIL_TPU_PACKED3D", raising=False)
    spec, _ = _specs("nvtiny")
    params = conditioned(init_stereo_params(spec, seed=2))
    save_params(jax.tree.map(jnp.asarray, params), tmp_path / "w.npz")
    big = np.random.RandomState(5).randint(0, 256, (50, 100, 3)).astype(
        np.uint8)
    cv2.imwrite(str(tmp_path / "l.png"), big)
    cv2.imwrite(str(tmp_path / "r.png"), np.roll(big, 2, axis=1))
    golden = np.random.RandomState(6).rand(*HW).astype(np.float32) * 16
    np.save(tmp_path / "golden.npy", golden)
    common = ["nvtiny", "--cpu", "--hw", *map(str, HW), "--weights",
              str(tmp_path / "w.npz"), "--left", str(tmp_path / "l.png"),
              "--right", str(tmp_path / "r.png"), "--dtype", "bf16",
              "--quantize", "int8", "--accuracy",
              str(tmp_path / "golden.npy")]
    japp.main(common + ["--out", str(tmp_path / "jax"), "--no-cache"])
    jlines = [json.loads(s) for s in capsys.readouterr().out.splitlines()
              if s.startswith("{")]
    stereo_app.main(common + ["--out", str(tmp_path / "port")])
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()
             if s.startswith("{")]
    assert [set(line) for line in lines] == [set(line) for line in jlines]
    rows, jrows = lines[0]["accuracy"], jlines[0]["accuracy"]
    assert [r["rung"] for r in rows] == [r["rung"] for r in jrows] == [
        "fp32", "bf16", "bf16+packed", "w8", "int8"]
    for r, j in zip(rows, jrows):
        assert abs(r["epe"] - j["epe"]) < (1e-3 if r["rung"] == "fp32"
                                           else 0.1), (r, j)
    got, want = read_bin(tmp_path / "port.bin"), read_bin(tmp_path /
                                                          "jax.bin")
    assert np.abs(got - want).mean() < 0.1


