"""The port's synthetic-training tools against the JAX package's, on the
CPU: `apps/train_r18_synth.py` against `tools/train_r18_synth.py` and
`apps/train_trailnet_synth.py` against `tools/train_trailnet_synth.py`.

- The committed ResNet-18 3D checkpoint (`tests/data/resnet18_synth_trained
  .npz`, made by the JAX tool): the port's loader bit-equal to JAX's, the
  port's held-out D1 at 160x512 (the twin of `tests/test_train_stereo.py`'s
  convergence gate), its fp32 disparity within 1e-3 px of JAX's
  `stereo_forward`, and the rung table against JAX's `print_rung_table`
  at 32x64 (fp32 and w8 rows within 1e-4, bf16 rows inside the 3D bf16
  gate, mean < 0.1 px of fp32).
- The r18 tool end to end at a tiny size: its JSON lines, its artifact's
  keys and ``@bf16`` encoding against the JAX tool's, a failing gate, a
  run from a given tree, and bf16 rounding bit for bit as `ml_dtypes`.
- The TrailNet tool: `render_batch` bit-equal, the schedule optax's at
  every step, steps from JAX's initial tree within 1e-4 relative of JAX's
  losses, held-out accuracy identical, the w8 artifact bit-equal.
- Both CLIs in a child process where ``jax`` and ``redtail_tpu`` cannot be
  imported, and the committed artifacts read by the port (fails, not
  skips, when one is missing).

Torch is held to two threads (the file runs beside others under xdist).
"""

import dataclasses
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from redtail_tpu_torch.apps import train_r18_synth as r18
from redtail_tpu_torch.data.kitti import (KittiStereoDataset,
                                          make_synthetic_kitti)
from redtail_tpu_torch.models import STEREO_SPECS, params_from_npz
from redtail_tpu_torch.models import trailnet as ptrail

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
DATA = ROOT / "tests" / "data"
R18_NPZ = DATA / "resnet18_synth_trained.npz"
TRAIL_NPZ = DATA / "trailnet_synth_trained.npz"
SMALL = ((32, 64), 8)        # the reduced crop and max_disp of the rungs
TINY = ["--crop", "32x64", "--max-disp", "8", "--n-train", "2",
        "--n-eval", "1", "--batch", "1", "--cpu"]
BF16_MEAN_PX = 0.1           # PERF.md §2: the 3D models' bf16 gate


def _tool(name):
    """A module of `tools/` (a script directory, not a package)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lines(out: str):
    return [json.loads(s) for s in out.splitlines() if s.startswith("{")]


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}" if path else k)
    else:
        yield path, tree


def _assert_trees_bit_equal(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = np.asarray(got[k])
        assert g.dtype == np.asarray(w).dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g.view(np.uint8),
                                      np.asarray(w).view(np.uint8),
                                      err_msg=k)


@pytest.fixture(autouse=True)
def _plain_switches(monkeypatch):
    # the packed head's switches are the rung function's to set; the
    # JAX-only Pallas and mask knobs stay off on both sides
    for var in ("REDTAIL_TPU_PACKED3D", "REDTAIL_TPU_DFOLD",
                "REDTAIL_TPU_PALLAS_CONV3D", "REDTAIL_TPU_MASK_FORM",
                "REDTAIL_TPU_MASK_MUL"):
        monkeypatch.delenv(var, raising=False)


def _held_out(root, hw, max_disp, n):
    """The r18 tools' held-out set: seed 1, octaves 3, disparities in
    [4, 2 * max_disp - 8]."""
    return KittiStereoDataset(make_synthetic_kitti(
        root, n=n, hw=hw, disp=(4, 2 * max_disp - 8), seed=1, octaves=3))


# ------------------------------------------------------ committed artifacts


@pytest.mark.parametrize("artifact", ["resnet18", "trailnet"])
def test_committed_artifacts_read_by_the_port(artifact):
    """The port's reads of the two committed artifacts: a missing file
    fails here, it does not skip."""
    if artifact == "resnet18":
        assert R18_NPZ.exists(), "committed ResNet-18 3D checkpoint missing"
        from redtail_tpu_torch.models import params_from_numpy
        net = params_from_numpy(STEREO_SPECS["resnet18"],
                                params_from_npz(R18_NPZ), device="cpu")
        assert net.spec.name == "resnet18"
    else:
        assert TRAIL_NPZ.exists(), "committed TrailNet checkpoint missing"
        net = ptrail.params_from_numpy(ptrail.params_from_w8_npz(TRAIL_NPZ),
                                       device="cpu")
        assert set(net.weight) == {n for n, _ in ptrail._layer_shapes()}


def test_r18_checkpoint_loads_bit_equal_to_jax():
    from redtail_tpu.models import params_from_npz as jax_params_from_npz

    _assert_trees_bit_equal(params_from_npz(R18_NPZ),
                            jax_params_from_npz(str(R18_NPZ),
                                                dtype=np.float32))


def test_r18_checkpoint_converged(tmp_path):
    """The twin of `tests/test_train_stereo.py`'s convergence gate: D1 <
    0.05 on the regenerated held-out pairs at the tool's 160x512 and
    max_disp 24, and the bf16 forward's D1 within 0.01 of fp32's."""
    from redtail_tpu_torch.training.stereo import evaluate_stereo

    ds = _held_out(tmp_path / "eval", (160, 512), 24, 2)
    spec = dataclasses.replace(STEREO_SPECS["resnet18"],
                               input_hw=(160, 512), max_disp=24)
    params = params_from_npz(R18_NPZ)
    ev = evaluate_stereo(spec, params, ds, device="cpu")
    assert ev["d1"] < 0.05, ev
    ev16 = evaluate_stereo(spec, params, ds, device="cpu",
                           dtype=torch.bfloat16)
    assert abs(ev16["d1"] - ev["d1"]) < 0.01, (ev, ev16)


def test_rung_table_matches_jax(tmp_path, capsys):
    """The port's rung function against the JAX tool's `print_rung_table`
    on the committed tree and one held-out pair at 32x64, max_disp 8: the
    same rows and keys; fp32 and w8 within 1e-4 (JAX's lines are rounded
    to 5 and 4 places, each within 5e-5 of its value); each bf16 row's
    mean drift from fp32 under the 3D bf16 gate; the fp32 disparity within
    1e-3 px of JAX's jitted `stereo_forward`."""
    import jax
    import jax.numpy as jnp

    from redtail_tpu.models import STEREO_SPECS as JSPECS
    from redtail_tpu.models import params_from_npz as jax_params_from_npz
    from redtail_tpu.models import stereo_forward as jax_forward

    hw, max_disp = SMALL
    ds = _held_out(tmp_path / "eval", hw, max_disp, 1)
    spec = dataclasses.replace(STEREO_SPECS["resnet18"], input_hw=hw,
                               max_disp=max_disp)
    jspec = dataclasses.replace(JSPECS["resnet18"], input_hw=hw,
                                max_disp=max_disp)
    rows = r18.print_rung_table(spec, R18_NPZ, ds, device="cpu")
    printed = _lines(capsys.readouterr().out)
    _tool("train_r18_synth").print_rung_table(jspec, R18_NPZ, ds)
    want = _lines(capsys.readouterr().out)

    assert [r["rung"] for r in rows] == [w["rung"] for w in want] \
        == ["fp32", "bf16", "bf16+packed", "w8"]
    # the CPU launches no kernel
    assert not any(v for r in rows for v in r["launches"].values())
    for row, line, w in zip(rows, printed, want):
        assert set(line) == set(w)
        if w["rung"] in ("fp32", "w8"):
            for k in w:
                if k != "rung":
                    assert row[k] == pytest.approx(w[k], abs=1e-4), (k, w)
        else:
            assert row["epe_vs_fp32"] < BF16_MEAN_PX, row
            assert w["epe_vs_fp32"] < BF16_MEAN_PX, w
            assert abs(row["d1_vs_gt"] - rows[0]["d1_vs_gt"]) < 0.01, row

    left, right, _, _ = ds.sample(0)
    jparams = jax_params_from_npz(str(R18_NPZ), dtype=np.float32)
    golden = np.asarray(jax.jit(lambda p, a, b: jax_forward(jspec, p, a, b))(
        jparams, jnp.asarray(left[None]), jnp.asarray(right[None])))[0]
    np.testing.assert_allclose(rows[0]["pred"], golden, atol=1e-3, rtol=0)



# ---------------------------------------------------------------- r18 tool


def test_bf16_rounding_matches_ml_dtypes():
    """The tool's bf16 rounding gives `ml_dtypes`' bits (the JAX tool's
    ``np.asarray(a, jnp.bfloat16)``): round to nearest even on ties, both
    zeros, subnormals, the overflow to inf, inf and NaN, and a million
    random bit patterns."""
    import ml_dtypes

    rs = np.random.RandomState(0)
    bits = rs.randint(0, 2 ** 32, size=1 << 20, dtype=np.uint64)
    edges = np.array([0x00000000, 0x80000000, 0x3f808000, 0x3f818000,
                      0x3f807fff, 0x3f808001, 0x00000001, 0x00008000,
                      0x007fffff, 0x7f7fffff, 0xff7fffff, 0x7f7f8000,
                      0x7f800000, 0xff800000], np.uint64)
    x = np.concatenate([edges, bits]).astype(np.uint32).view(np.float32)
    got = r18.bf16_tree({"a": x})["a"].view(torch.int16).numpy().view(
        np.uint16)
    with np.errstate(invalid="ignore"):  # NaN inputs
        want = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    nan = np.isnan(x)
    np.testing.assert_array_equal(got[~nan], want[~nan])
    back = torch.from_numpy(got[nan].view(np.int16)).view(
        torch.bfloat16).float().numpy()
    assert np.isnan(back).all()


def test_r18_tool_end_to_end(tmp_path, capsys):
    """Two steps at 32x64 on the CPU: exit 0, the JAX tool's JSON lines
    and keys, an artifact with the committed JAX-tool artifact's keys,
    shapes and ``@bf16`` encoding (the keys do not depend on the crop),
    read by JAX's `params_from_npz` as the port's loader reads it."""
    from redtail_tpu.models import params_from_npz as jax_params_from_npz

    out = tmp_path / "r18.npz"
    rc = r18.main(TINY + ["--steps", "2", "--d1-gate", "1.0", "--rungs",
                          "--out", str(out)])
    assert rc == 0
    lines = _lines(capsys.readouterr().out)
    final = next(r for r in lines if "final_eval" in r)
    assert set(final["final_eval"]) == {"d1", "epe", "images"}
    saved = next(r for r in lines if "params" in r)
    assert saved == {"params": str(out), "bytes": out.stat().st_size}
    rungs = [r for r in lines if "rung" in r]
    assert [r["rung"] for r in rungs] == ["fp32", "bf16", "bf16+packed",
                                          "w8"]
    assert all(set(r) == {"rung", "d1_vs_fp32", "epe_vs_fp32", "d1_vs_gt",
                          "epe_vs_gt"} for r in rungs)
    assert lines.index(final) < lines.index(saved) < lines.index(rungs[0])

    with np.load(out) as got, np.load(R18_NPZ) as want:
        assert sorted(got.files) == sorted(want.files)
        assert all(k.endswith("@bf16") for k in got.files)
        for k in want.files:
            assert got[k].dtype == want[k].dtype == np.uint16, k
            assert got[k].shape == want[k].shape, k
    _assert_trees_bit_equal(params_from_npz(out),
                            jax_params_from_npz(str(out), dtype=np.float32))


def test_r18_tool_failed_gate_writes_nothing(tmp_path, capsys):
    out = tmp_path / "r18.npz"
    rc = r18.main(TINY + ["--steps", "0", "--d1-gate", "-1", "--out",
                          str(out)])
    assert rc == 1 and not out.exists()
    err = _lines(capsys.readouterr().out)[-1]
    assert err["error"] == "d1 gate failed" and err["gate"] == -1


def test_r18_tool_from_a_given_tree_saves_as_jax(tmp_path, capsys):
    """`run` from a given fp32 tree with no step: the final eval is the
    tree's, and the artifact's arrays are bit for bit those of the JAX
    tool's save of the same tree (its `ml_dtypes` rounding and
    `save_params`)."""
    import jax
    import jax.numpy as jnp

    from redtail_tpu.utils.checkpoint import save_params as jax_save
    from redtail_tpu_torch.models import init_stereo_params
    from redtail_tpu_torch.training.stereo import evaluate_stereo

    hw, max_disp = SMALL
    spec = dataclasses.replace(STEREO_SPECS["resnet18"], input_hw=hw,
                               max_disp=max_disp)
    tree = init_stereo_params(spec, seed=3)
    out = tmp_path / "port.npz"
    args = r18.parse_args(TINY + ["--steps", "0", "--d1-gate", "1.0",
                                  "--out", str(out)])
    assert r18.run(args, init_params=tree) == 0
    final = next(r for r in _lines(capsys.readouterr().out)
                 if "final_eval" in r)["final_eval"]
    assert final == evaluate_stereo(spec, tree, _held_out(
        tmp_path / "eval", hw, max_disp, 1), device="cpu")

    jax_save(jax.tree_util.tree_map(lambda a: np.asarray(a, jnp.bfloat16),
                                    tree), tmp_path / "jax.npz")
    with np.load(out) as got, np.load(tmp_path / "jax.npz") as want:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ------------------------------------------------------------- no JAX


_NO_JAX = ("import sys; sys.modules['jax'] = None; "
           "sys.modules['redtail_tpu'] = None; sys.argv[0] = 'tool'; "
           "import torch; torch.set_num_threads(2); ")


def test_tool_runs_without_jax(tmp_path):
    out = str(tmp_path / "out.npz")
    argv = TINY + ["--steps", "2", "--d1-gate", "1.0", "--out", out]
    code = (_NO_JAX + "from redtail_tpu_torch.apps import train_r18_synth; "
            f"sys.exit(train_r18_synth.main({argv!r}))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert _lines(proc.stdout)[-1] == {"params": out,
                                       "bytes": Path(out).stat().st_size}
