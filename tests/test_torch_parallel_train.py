"""Data-parallel and spatially sharded training of the port
(`parallel/training.py:make_train_step(mesh=)`, `train_app stereo
--data-parallel`) on the CPU, in gloo ranks spawned by
`parallel/launch.py`, against the JAX package's unsharded step.

- One step on meshes (2, 1), (1, 2) and (2, 2) for NVTiny and ResNet18-2D
  at 32x64, max_disp 4, batch 4, fp32, from the same numpy params (biases
  random, ResNet18-2D's residual weights scaled by 0.3), with a valid mask
  whose density differs between the ranks' shards (so a mean of per-rank
  means would miss): the global loss and EPE within 1e-4 relative of
  JAX's (`jax.value_and_grad` of the JAX step's own loss over the whole
  batch), every gradient leaf within 1e-4 of its largest value (the leaf
  whose exact gradient is 0 near 0), and the params after the update
  bit-equal on every rank;
- the correlation model trains over the data axis;
- `train_app stereo --cpu --data-parallel 2` logs the losses of
  ``--data-parallel 1`` over 2 steps and writes one checkpoint.

The JAX references are computed while the ranks run.
"""

import concurrent.futures
import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from redtail_tpu.models import STEREO_SPECS as JSPECS
from redtail_tpu.models import stereo as jstereo
from redtail_tpu.ops.convolution import plain_lowering as jplain_lowering
from redtail_tpu.parallel.training import (
    smooth_l1_disparity_loss as jsmooth_l1)

from redtail_tpu_torch.apps.train_app import main as train_main
from redtail_tpu_torch.data import kitti
from redtail_tpu_torch.models import STEREO_SPECS, init_stereo_params
from redtail_tpu_torch.parallel import rank_checks
from redtail_tpu_torch.parallel.launch import spawn_ranks

CROP = (32, 64)
MAX_DISP = 4
BATCH = 4
MODELS = ("nvtiny", "resnet18_2d")
MESHES = ((2, 1), (1, 2), (2, 2))
# the bias of the 3D models' last deconv has an exact gradient of 0 (the
# soft-argmin ignores a shift): rounding noise on both sides
ZERO_GRAD = {"/decoder3D/deconv3D_3/biases": 1e-6}


def conditioned(params, seed=7):
    rs = np.random.RandomState(seed)

    def walk(node, path):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v, f"{path}/{k}")
            elif k == "biases":
                out[k] = (rs.randn(*v.shape) * 0.1).astype(np.float32)
            elif path.endswith(("res_conv2", "encoder2D_out")):
                out[k] = (v * 0.3).astype(np.float32)
            else:
                out[k] = v
        return out
    return walk(params, "")


def _batch(seed=3):
    """A global batch whose valid pixels thin out by sample and by row, so
    every shard of every mesh holds its own count."""
    rs = np.random.RandomState(seed)
    left, right = (rs.rand(BATCH, *CROP, 3).astype(np.float32)
                   for _ in range(2))
    target = (rs.rand(BATCH, *CROP) * 6).astype(np.float32)
    keep = (0.9 - 0.2 * np.arange(BATCH)[:, None, None]
            - 0.3 * (np.arange(CROP[0]) >= CROP[0] // 2)[None, :, None])
    valid = (rs.rand(BATCH, *CROP) < keep).astype(np.float32)
    return left, right, target, valid


def _leaves(tree, path=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{path}/{k}")
        else:
            yield f"{path}/{k}", v


def _jax_step(name, params, batch):
    """The JAX step's loss (its `loss_fn`: the forward under
    `plain_lowering()`, the correlation model's output in pixels, the
    masked smooth-L1 over the whole batch), EPE and gradients."""
    jspec = dataclasses.replace(JSPECS[name], input_hw=CROP,
                                max_disp=MAX_DISP)
    left, right, target, valid = batch

    def loss_fn(p):
        with jplain_lowering():
            pred = jstereo.stereo_forward(jspec, p, left, right)
        if jspec.corr:
            pred = pred * jspec.input_hw[1]
        return jsmooth_l1(pred, target, valid), pred

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    (loss, pred), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jp)
    epe = jsmooth_l1(pred, target, valid, delta=1e-9)
    return float(loss), float(epe), dict(_leaves(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), grads)))


@pytest.fixture(scope="module")
def steps():
    """{(model, mesh): (JAX (loss, epe, grads), per-rank results, init
    params)}: the ranks of each world size run while JAX computes."""
    batch = _batch()
    params = {m: conditioned(init_stereo_params(
        dataclasses.replace(STEREO_SPECS[m], input_hw=CROP,
                            max_disp=MAX_DISP), seed=1)) for m in MODELS}
    by_world = {}
    for mesh in MESHES:
        for m in MODELS:
            by_world.setdefault(mesh[0] * mesh[1], []).append((m, mesh))
    with concurrent.futures.ThreadPoolExecutor(len(by_world)) as pool:
        futures = {world: pool.submit(
            spawn_ranks, rank_checks.train_cases, world, backend="gloo",
            device_type="cpu", args=([{
                "spec": {"name": m, "input_hw": CROP, "max_disp": MAX_DISP},
                "params": params[m], "batch": batch, "mesh": mesh}
                for m, mesh in keys], "cpu"))
            for world, keys in by_world.items()}
        want = {m: _jax_step(m, params[m], batch) for m in MODELS}
        out = {}
        for world, keys in by_world.items():
            ranks = futures[world].result()
            for i, key in enumerate(keys):
                out[key] = (want[key[0]], [r[i] for r in ranks],
                            params[key[0]])
    return out


KEYS = [(m, mesh) for mesh in MESHES for m in MODELS]
IDS = [f"{m}-{mesh[0]}x{mesh[1]}" for m, mesh in KEYS]


@pytest.mark.parametrize("key", KEYS, ids=IDS)
def test_mesh_step_loss_matches_jax(steps, key):
    (loss, epe, _), ranks, _ = steps[key]
    for r in ranks:
        assert abs(r["loss"] - loss) <= 1e-4 * abs(loss), (r["loss"], loss)
        assert abs(r["epe"] - epe) <= 1e-4 * abs(epe), (r["epe"], epe)


@pytest.mark.parametrize("key", KEYS, ids=IDS)
def test_mesh_step_grads_match_jax(steps, key):
    (_, _, want), ranks, _ = steps[key]
    for r in ranks:
        got = dict(_leaves(r["grads"]))
        assert sorted(got) == sorted(want)
        for path, w in want.items():
            g = got[path]
            if path in ZERO_GRAD:
                bound = ZERO_GRAD[path]
                assert np.abs(g).max() <= bound and np.abs(w).max() <= bound
                continue
            err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
            assert err <= 1e-4, (path, err)


@pytest.mark.parametrize("key", KEYS, ids=IDS)
def test_mesh_step_params_bit_equal_across_ranks(steps, key):
    _, ranks, init = steps[key]
    first = dict(_leaves(ranks[0]["params"]))
    for r in ranks[1:]:
        for path, a in _leaves(r["params"]):
            np.testing.assert_array_equal(a, first[path], err_msg=path)
    moved = [not np.array_equal(first[p], v) for p, v in _leaves(init)]
    assert sum(moved) > len(moved) // 2


def test_corr_model_trains(steps):
    """`tests/test_parallel.py:test_corr_model_trains`: ResNet18-2D over
    the data axis gives a finite loss and moves its weights."""
    _, ranks, init = steps[("resnet18_2d", (2, 1))]
    assert all(np.isfinite(r["loss"]) for r in ranks)
    after = dict(_leaves(ranks[0]["params"]))
    w0 = init["encoder2D"]["conv1"]["weights"]
    assert np.abs(after["/encoder2D/conv1/weights"] - w0).max() > 0


@pytest.fixture(scope="module")
def kitti_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti")
    return kitti.make_synthetic_kitti(root, n=3, hw=(40, 72), disp=3.0)


def test_train_app_data_parallel_matches_one_process(kitti_dir, tmp_path,
                                                     capfd):
    """Two gloo ranks over the global batch log the one process's losses;
    rank 0 alone logs and writes the checkpoint and --out."""
    recs = {}
    for dp in (1, 2):
        ck = tmp_path / f"ck{dp}"
        rc = train_main(["stereo", "--cpu", "--data", str(kitti_dir),
                         "--model", "nvtiny", "--crop", "32x64",
                         "--max-disp", "4", "--batch", "2", "--steps", "2",
                         "--warmup", "1", "--ckpt-dir", str(ck), "--out",
                         str(tmp_path / f"p{dp}.npz"), "--data-parallel",
                         str(dp)])
        assert rc == 0
        lines = capfd.readouterr().out.splitlines()
        recs[dp] = [json.loads(line) for line in lines
                    if line.startswith("{")]
        assert [p.name for p in ck.iterdir()] == ["nvtiny_train.npz"]
    losses = {dp: [r["loss"] for r in rs if "loss" in r]
              for dp, rs in recs.items()}
    assert len(losses[1]) == 1 and losses[2] == losses[1]
    # one rank logs: the records of two ranks would double the lines
    assert len(recs[2]) == len(recs[1])
    a, b = (np.load(tmp_path / f"p{dp}.npz") for dp in (1, 2))
    for k in a.files:
        if "/" + k in ZERO_GRAD:
            # Adam turns its rounding-noise gradient into lr-sized steps
            continue
        np.testing.assert_allclose(b[k], a[k], atol=1e-6, rtol=0,
                                   err_msg=k)
