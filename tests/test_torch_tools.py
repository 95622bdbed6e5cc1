"""The port's JAX-free tools against the JAX package's, on the CPU:
`apps/convert_model.py` against `tools/convert_model.py` (the blob byte for
byte, the .npz array for array) and `apps/eval_disparity.py` against
`tools/eval_disparity.py` (D1 / EPE to 1e-6), on the repo's NVSmall
weights (`tests/data/nvsmall_golden.npz`), a blob and a TF checkpoint
written here, the golden disparities of `tests/data/` and maps derived from
them. Then both CLIs in a child process where ``jax`` and ``redtail_tpu``
cannot be imported.
"""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from redtail_tpu_torch.apps import convert_model, eval_disparity
from redtail_tpu_torch.io import write_bin, write_trt_weights
from redtail_tpu_torch.models import STEREO_SPECS, params_from_npz
from test_torch_stereo import conditioned
from test_torch_weights_io import stereo_bundle

ROOT = Path(__file__).resolve().parent.parent
DATA = ROOT / "tests" / "data"


def _tool(name):
    """A module of `tools/` (a script directory, not a package)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json_line(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _npz_equal(a, b):
    with np.load(a) as x, np.load(b) as y:
        assert sorted(x.files) == sorted(y.files)
        for k in x.files:
            assert x[k].dtype == y[k].dtype, k
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


@pytest.fixture(scope="module")
def nvsmall_blob(tmp_path_factory):
    """NVSmall's repo weights as an fp32 TRT blob (the port's writer)."""
    path = tmp_path_factory.mktemp("blob") / "nvsmall.bin"
    tree = params_from_npz(DATA / "nvsmall_golden.npz")
    write_trt_weights(convert_model.tree_to_blob(STEREO_SPECS["nvsmall"],
                                                 tree), path)
    return path


def test_tree_to_blob_matches_the_jax_tool():
    from redtail_tpu.models import STEREO_SPECS as JSPECS

    tree = params_from_npz(DATA / "nvsmall_golden.npz")
    got = convert_model.tree_to_blob(STEREO_SPECS["nvsmall"], tree)
    want = _tool("convert_model").tree_to_blob(JSPECS["nvsmall"], tree)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("blob_dtype", ["fp32", "fp16"])
def test_convert_blob_matches_the_jax_tool(tmp_path, capsys, nvsmall_blob,
                                           blob_dtype):
    outs = {}
    for who, main in (("port", convert_model.main),
                      ("jax", _tool("convert_model").main)):
        outs[who] = (tmp_path / f"{who}.bin", tmp_path / f"{who}.npz")
        rc = main(["--model", "nvsmall", "--in-blob", str(nvsmall_blob),
                   "--out-blob", str(outs[who][0]), "--blob-dtype",
                   blob_dtype, "--out-npz", str(outs[who][1])])
        assert rc == 0
        line = _json_line(capsys)
        assert line == {"model": "nvsmall",
                        "wrote": [str(p) for p in outs[who]]}
    assert outs["port"][0].read_bytes() == outs["jax"][0].read_bytes()
    _npz_equal(outs["port"][1], outs["jax"][1])


@pytest.mark.parametrize("kind", ["<f4", "<f2"])
def test_convert_checkpoint_matches_the_jax_tool(tmp_path, capsys, kind):
    spec = STEREO_SPECS["resnet18_2d"]
    from redtail_tpu_torch.models import init_stereo_params
    stereo_bundle(tmp_path / "ckpt", spec,
                  conditioned(init_stereo_params(spec, seed=3)), kind)
    outs = {}
    for who, main in (("port", convert_model.main),
                      ("jax", _tool("convert_model").main)):
        outs[who] = (tmp_path / f"{who}.bin", tmp_path / f"{who}.npz")
        assert main(["--model", "resnet18_2d", "--checkpoint",
                     str(tmp_path / "ckpt"), "--out-blob",
                     str(outs[who][0]), "--out-npz",
                     str(outs[who][1])]) == 0
        capsys.readouterr()
    assert outs["port"][0].read_bytes() == outs["jax"][0].read_bytes()
    _npz_equal(outs["port"][1], outs["jax"][1])


def test_convert_needs_a_source(capsys):
    assert convert_model.main(["--model", "nvtiny"]) == 1
    assert "need --checkpoint or --in-blob" in capsys.readouterr().err


def _maps(tmp_path):
    """(pred, gt) pairs in every format the tools read: the repo's golden
    disparities against copies moved by a seeded error field (a sparse gt
    with holes for the default mode)."""
    import cv2

    gt = np.squeeze(np.load(DATA / "nvtiny_golden_disp.npy")) \
        .astype(np.float32)
    rs = np.random.RandomState(4)
    pred = gt + rs.randn(*gt.shape).astype(np.float32) * 2.0
    sparse = np.where(rs.rand(*gt.shape) < 0.3, 0.0, gt).astype(np.float32)
    np.save(tmp_path / "pred.npy", pred)
    np.save(tmp_path / "gt.npy", gt)
    np.save(tmp_path / "sparse.npy", sparse)
    write_bin(pred, tmp_path / "pred.bin")
    png = np.clip(np.abs(pred) * 256.0, 0, 65535).astype(np.uint16)
    cv2.imwrite(str(tmp_path / "pred.png"), png)
    r2d = np.squeeze(np.load(DATA / "resnet18_2d_golden_disp.npy"))
    w = r2d.shape[-1]
    cv2.imwrite(str(tmp_path / "r2d.png"),
                np.clip(r2d * w, 0, 65535).astype(np.uint16))
    np.save(tmp_path / "r2d.npy", (r2d * w).astype(np.float32))
    return w


@pytest.mark.parametrize("args", [
    ["pred.npy", "gt.npy", "--dense"],
    ["pred.npy", "sparse.npy"],
    ["pred.bin", "gt.npy", "--dense"],
    ["pred.png", "gt.npy", "--dense"],
    ["r2d.png", "r2d.npy", "--dense", "--png-scale", "WIDTH"],
], ids=["npy-dense", "npy-sparse", "bin", "png", "png-width"])
def test_eval_disparity_matches_the_jax_tool(tmp_path, capsys, args):
    w = _maps(tmp_path)
    argv = [str(tmp_path / a) if a.endswith((".npy", ".bin", ".png"))
            else str(w) if a == "WIDTH" else a for a in args]
    eval_disparity.main(argv)
    got = _json_line(capsys)
    _tool("eval_disparity").main(argv)
    want = _json_line(capsys)
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-6), k
    assert got["n_valid"] == want["n_valid"]


_NO_JAX = ("import sys; sys.modules['jax'] = None; "
           "sys.modules['redtail_tpu'] = None; sys.argv[0] = 'tool'; ")


@pytest.mark.parametrize("tool", ["convert_model", "eval_disparity"])
def test_tools_run_without_jax(tmp_path, nvsmall_blob, tool):
    if tool == "convert_model":
        argv = ["--model", "nvsmall", "--in-blob", str(nvsmall_blob),
                "--out-blob", str(tmp_path / "o.bin"), "--out-npz",
                str(tmp_path / "o.npz")]
    else:
        _maps(tmp_path)
        argv = [str(tmp_path / "pred.npy"), str(tmp_path / "gt.npy"),
                "--dense"]
    code = (_NO_JAX + f"from redtail_tpu_torch.apps import {tool}; "
            f"sys.exit({tool}.main({argv!r}))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    if tool == "convert_model":
        assert line["wrote"] == argv[5::2]
        assert (tmp_path / "o.bin").read_bytes() == nvsmall_blob.read_bytes()
    else:
        assert line["n_valid"] > 0 and 0 < line["epe"] < 3
