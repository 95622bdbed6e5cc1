"""The training slice's loaders, checkpoints and `train_app`, on the CPU.

- Params bundles: `save_params` / `load_params` of both packages read each
  other's files, bf16 leaves included, and write the same arrays (keys,
  dtypes and bytes equal) for the same params.
- The train state: a run of 2 + 2 steps through `save_train_state` /
  `load_train_state` ends bit-equal to 4 steps in one go (the warmup
  schedule's lr differs at every one of them); a checkpoint of another
  optimizer is refused.
- The datasets (own copies of the JAX package's `data/`): the same batches
  and lists as the JAX loaders from the same files and seeds.
- `train_app stereo --cpu` and `train_app trailnet --cpu` on synthetic data:
  ``--out`` serves through `stereo_app`'s loader / a `TrailNetNode`,
  ``--resume`` continues, ``--export-caffe`` loads in the port's
  `CaffeNet` and agrees with the native net; ``--data-parallel 2`` raises.
- Without ``--cpu`` / ``device="cpu"`` every training entry point asks for
  the card, and raises without one.
"""

import dataclasses
import json

import ml_dtypes
import numpy as np
import pytest
import torch

from redtail_tpu.data import kitti as jkitti
from redtail_tpu.data import trails as jtrails
from redtail_tpu.utils import checkpoint as jckpt

from redtail_tpu_torch.data import kitti, trails
from redtail_tpu_torch.io.caffe import load_caffemodel, load_prototxt
from redtail_tpu_torch.models import CaffeNet, STEREO_SPECS
from redtail_tpu_torch.models import trailnet as tn
from redtail_tpu_torch.models.stereo import (init_stereo_params,
                                             params_from_npz,
                                             params_to_numpy)
from redtail_tpu_torch.parallel.training import (OptimizerSpec,
                                                 make_train_step)
from redtail_tpu_torch.runtime import StereoNode, TrailNetNode
from redtail_tpu_torch.training.stereo import (StereoTrainConfig,
                                               _make_optimizer, _make_spec,
                                               load_train_state,
                                               save_train_state)
from redtail_tpu_torch.utils import checkpoint as ckpt
from redtail_tpu_torch.apps.train_app import main as train_main

CROP = (32, 64)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """A few intra-op threads: the tier-1 run puts six test workers on the
    cores, and oversubscribed CPU convs run an order of magnitude slower
    (restored after)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, 2))
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def kitti_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti")
    return kitti.make_synthetic_kitti(root, n=3, hw=(40, 72), disp=3.0)


@pytest.fixture(scope="module")
def trails_dir(tmp_path_factory):
    import cv2

    root = tmp_path_factory.mktemp("trails")
    rng = np.random.RandomState(0)
    for cls in ("lc", "sc", "rc"):
        d = root / "vid0" / cls
        d.mkdir(parents=True)
        for i in range(2):
            cv2.imwrite(str(d / f"{i}.png"),
                        rng.randint(0, 255, (180, 320, 3)).astype(np.uint8))
    return root


# ------------------------------------------------------------ params npz


def _tree(seed=0):
    rs = np.random.RandomState(seed)
    return {"enc": {"conv": {"weights": rs.randn(3, 3, 2, 4).astype(
        np.float32), "biases": rs.randn(4).astype(np.float32)}},
        "head": {"w": rs.randn(5).astype(np.float32)}}


def _same_npz(a, b):
    with np.load(a) as x, np.load(b) as y:
        assert sorted(x.files) == sorted(y.files)
        for k in x.files:
            assert x[k].dtype == y[k].dtype and x[k].shape == y[k].shape
            assert x[k].tobytes() == y[k].tobytes(), k


def test_params_npz_round_trips_both_ways_with_bf16(tmp_path):
    tree = _tree()
    bf = tree["head"]["w"].astype(ml_dtypes.bfloat16)
    jtree = {**tree, "head": {"w": bf}}
    ptree = {**tree, "head": {"w": torch.from_numpy(
        bf.view(np.uint16).view(np.int16).copy()).view(torch.bfloat16)}}
    jpath, ppath = tmp_path / "jax.npz", tmp_path / "port.npz"
    jckpt.save_params(jtree, jpath)
    ckpt.save_params(ptree, ppath)
    _same_npz(jpath, ppath)

    # JAX's file through the port and back, and the port's through JAX
    back = ckpt.load_params(jpath)
    assert back["head"]["w"].dtype == torch.bfloat16
    assert back["head"]["w"].view(torch.int16).numpy().view(
        np.uint16).tobytes() == bf.view(np.uint16).tobytes()
    ckpt.save_params(back, tmp_path / "again.npz")
    _same_npz(jpath, tmp_path / "again.npz")
    jback = jckpt.load_params(ppath)
    assert jback["head"]["w"].dtype == ml_dtypes.bfloat16
    assert jback["head"]["w"].tobytes() == bf.tobytes()
    np.testing.assert_array_equal(jback["enc"]["conv"]["weights"],
                                  tree["enc"]["conv"]["weights"])
    # the models' loader widens bf16 exactly
    flat = ckpt.load_npz_flat(ppath)
    np.testing.assert_array_equal(flat["head/w"], bf.astype(np.float32))
    with pytest.raises(ValueError, match="npz"):
        ckpt.save_params(tree, tmp_path / "dir_ckpt")


# ---------------------------------------------------------- train state


def _cfg(**kw):
    base = dict(model="nvtiny", crop_hw=CROP, max_disp=4, batch_size=2,
                steps=4, lr=1e-3, warmup_steps=2)
    base.update(kw)
    return StereoTrainConfig(**base)


def _run(cfg, batches, state=None):
    spec = _make_spec(cfg)
    init_fn, step_fn = make_train_step(spec, _make_optimizer(cfg),
                                       device="cpu")
    template = init_fn(init_stereo_params(spec, seed=cfg.seed))
    state = state(template) if callable(state) else template
    for b in batches:
        state, _ = step_fn(state, *b)
    return state


def test_resume_is_bit_equal_and_refuses_another_optimizer(kitti_dir,
                                                           tmp_path):
    ds = kitti.KittiStereoDataset(kitti_dir)
    rng = np.random.RandomState(1)
    batches = [next(ds.batches(2, CROP, rng=rng)) for _ in range(4)]
    cfg = _cfg()
    whole = _run(cfg, batches)
    first = _run(cfg, batches[:2])
    path = save_train_state(first, tmp_path / "state.npz")
    resumed = _run(cfg, batches[2:],
                   state=lambda t: load_train_state(path, t))
    assert resumed.step == whole.step == 4
    assert resumed.schedule.get_last_lr() == whole.schedule.get_last_lr()
    for a, b in zip(resumed.params.parameters(), whole.params.parameters()):
        assert torch.equal(a, b)
    # the saved params serve through `stereo_app --weights`' loader
    tree = params_from_npz(path)
    np.testing.assert_array_equal(
        tree["encoder2D"]["conv1"]["weights"],
        params_to_numpy(first.params)["encoder2D"]["conv1"]["weights"])

    spec = _make_spec(cfg)
    init_fn, _ = make_train_step(spec, OptimizerSpec("sgd", 1e-3,
                                                     momentum=0.9),
                                 device="cpu")
    with pytest.raises(ValueError, match="optimizer"):
        load_train_state(path, init_fn(init_stereo_params(spec)))


# ------------------------------------------------------------- datasets


def test_kitti_batches_equal_the_jax_loaders(kitti_dir):
    mine, theirs = (m.KittiStereoDataset(kitti_dir) for m in (kitti, jkitti))
    assert len(mine) == len(theirs) == 3
    for random_crop in (True, False):
        got = list(mine.batches(2, (24, 48), rng=np.random.RandomState(5),
                                random_crop=random_crop, drop_last=False))
        want = list(theirs.batches(2, (24, 48),
                                   rng=np.random.RandomState(5),
                                   random_crop=random_crop,
                                   drop_last=False))
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="batch_size"):
        next(mine.batches(8, CROP))


def test_trail_lists_and_batches_equal_the_jax_loaders(trails_dir):
    mine, theirs = (m.build_trail_lists(trails_dir, seed=3)
                    for m in (trails, jtrails))
    assert mine == theirs and len(mine["train"]) == 6
    got = list(trails.TrailsDataset(mine["train"], seed=2).batches(4))
    want = list(jtrails.TrailsDataset(theirs["train"], seed=2).batches(4))
    for (gi, gl), (wi, wl) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)
    assert trails.balance_samples({0: [1], 1: [2, 3, 4]}, seed=1) == \
        jtrails.balance_samples({0: [1], 1: [2, 3, 4]}, seed=1)


# ------------------------------------------------------------ train_app


def _records(capsys):
    return [json.loads(s) for s in capsys.readouterr().out.splitlines()
            if s.startswith("{")]


def test_train_app_stereo_cpu_out_and_resume(kitti_dir, tmp_path, capsys):
    out, ck = tmp_path / "params.npz", tmp_path / "ck"
    argv = ["stereo", "--cpu", "--data", str(kitti_dir), "--model",
            "resnet18_2d", "--crop", "32x64", "--max-disp", "4", "--batch",
            "2", "--warmup", "1", "--ckpt-dir", str(ck), "--out", str(out)]
    assert train_main(argv + ["--steps", "2"]) == 0
    recs = _records(capsys)
    assert any("eval_d1" in r for r in recs)
    assert {"params": str(out)} in recs
    assert train_main(argv + ["--steps", "3", "--resume"]) == 0
    recs = _records(capsys)
    steps = [r["step"] for r in recs if "loss" in r]
    assert steps == [3]  # resumed at step 2: one more step
    # served as `stereo_app --weights <out>` loads an .npz
    spec = dataclasses.replace(STEREO_SPECS["resnet18_2d"], input_hw=CROP,
                               max_disp=4)
    node = StereoNode(spec, params_from_npz(out), device="cpu")
    rs = np.random.RandomState(0)
    disp = node(*(rs.randint(0, 256, CROP + (3,)).astype(np.uint8)
                  for _ in range(2)))
    assert disp.shape == CROP and np.isfinite(disp).all()


def test_train_app_trailnet_cpu_out_and_caffe_export(trails_dir, tmp_path,
                                                     capsys):
    out, prefix = tmp_path / "trail.npz", tmp_path / "export" / "trail"
    assert train_main(["trailnet", "--cpu", "--data", str(trails_dir),
                       "--batch", "2", "--steps", "2", "--warmup", "1",
                       "--out", str(out), "--export-caffe",
                       str(prefix)]) == 0
    recs = _records(capsys)
    assert [r["step"] for r in recs if "loss" in r] == [2]
    params = ckpt.load_params(out)
    net = tn.params_from_numpy(params, device="cpu")
    caffe = CaffeNet(load_prototxt(prefix.with_suffix(".prototxt")),
                     load_caffemodel(prefix.with_suffix(".caffemodel")),
                     device="cpu")
    frame = np.random.RandomState(1).randint(0, 256, tn.INPUT_HW + (3,))
    frame = frame.astype(np.uint8)
    probs = TrailNetNode(net, device="cpu")(frame)
    assert probs.shape == (6,) and np.isfinite(probs).all()
    with torch.no_grad():
        want = tn.trailnet_predict(caffe, frame)[0].numpy()
    np.testing.assert_allclose(probs, want, rtol=0, atol=1e-4)


def test_train_app_data_parallel_raises(kitti_dir, tmp_path, monkeypatch,
                                       capfd):
    """``--data-parallel 2`` needs two cards for its NCCL ranks and raises
    with fewer; with ``--cpu`` it runs two gloo ranks
    (`tests/test_torch_parallel_train.py` holds their losses to one
    process's)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="only 1 visible"):
        train_main(["stereo", "--data", str(kitti_dir), "--data-parallel",
                    "2", "--steps", "1"])
    monkeypatch.undo()
    out = tmp_path / "p.npz"
    assert train_main(["stereo", "--cpu", "--data", str(kitti_dir),
                       "--model", "nvtiny", "--crop", "32x64", "--max-disp",
                       "4", "--batch", "2", "--data-parallel", "2",
                       "--steps", "1", "--out", str(out)]) == 0
    recs = [json.loads(line) for line in capfd.readouterr().out.splitlines()
            if line.startswith("{")]
    assert [r["step"] for r in recs if "loss" in r] == [1]
    assert out.exists()


def test_train_entry_points_default_to_the_card(kitti_dir, trails_dir,
                                                monkeypatch):
    from redtail_tpu_torch.training.stereo import (evaluate_stereo,
                                                   train_stereo)
    from redtail_tpu_torch.training.trailnet import make_trailnet_train_step

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _cfg(steps=1)
    spec = _make_spec(cfg)
    ds = kitti.KittiStereoDataset(kitti_dir)
    for call in (lambda: make_train_step(spec),
                 lambda: make_trailnet_train_step(),
                 lambda: train_stereo(cfg, ds),
                 lambda: evaluate_stereo(spec, init_stereo_params(spec), ds),
                 lambda: train_main(["stereo", "--data", str(kitti_dir)]),
                 lambda: train_main(["trailnet", "--data",
                                     str(trails_dir)])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
