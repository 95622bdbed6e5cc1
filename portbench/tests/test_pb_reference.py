"""The plain reference against the program's CPU path at a small size:
each serving cell's forward under its configuration's head, and the
correlation family's (ResNet18-2D, which has no cell yet) through the same
node (uint8 frames in, as `StereoNode` takes them), and one train step of
each family, in float32 where the two must agree to rounding."""

import numpy as np
import pytest
import torch

from portbench.harness import data, port
from portbench.reference import stereo as ref
from portbench.tests.tiny import TRAIN, tiny_cell, tiny_corr_config

CORR = "resnet18_2d"  # the correlation family, served as NVSmall's cell is
CELLS = ("nvsmall.serve", "resnet18_3d.serve", "nvsmall.serve.packed",
         CORR)
# bf16 against the fp32 reference, the mean gap of a frame in pixels: the
# correlation net's output is its sigmoid carried in bf16, times the width
# (0.25 px steps at the ~46 px it reads here; it reads 0.12-0.14 px)
BF16_MEAN_GAP = {CORR: 0.5}


def _setup(name, seed=2 ** 31 + 11):
    if name == CORR:
        cell = tiny_cell("nvsmall.serve")
        cell.config = tiny_corr_config()
    else:
        cell = tiny_cell(name)
    g = data.generator(seed, "cpu")
    tree = data.make_weights(cell.config, g, "cpu")
    return cell, g, tree


@pytest.mark.parametrize("name", CELLS)
def test_served_forward_fp32(name):
    cell, g, tree = _setup(name)
    left, right, shifts = data.make_frames(cell.config, cell.traffic, g,
                                           "cpu")
    assert len(set(shifts.tolist())) > 1
    spec = port.port_spec(cell.config)
    from redtail_tpu_torch.runtime.nodes import StereoNode
    node = StereoNode(spec, tree, dtype=torch.float32, device="cpu")
    p = ref.to_torch(tree, cell.config, "cpu")
    for k in range(2):
        with port.head_context(cell.config):
            got = node(left[k], right[k])
        want = ref.forward(p, cell.config,
                           ref.frames_to_rgb(torch.from_numpy(left[k:k + 1])),
                           ref.frames_to_rgb(torch.from_numpy(right[k:k + 1])))
        want = want[0].numpy()
        assert got.shape == want.shape == tuple(cell.config["input_hw"])
        assert np.abs(got - want).max() < 1e-3
        assert want.std() > 1e-3  # the soft-argmin is not pinned


@pytest.mark.parametrize("name", CELLS)
def test_served_forward_bf16_near(name):
    cell, g, tree = _setup(name)
    left, right, _ = data.make_frames(cell.config, cell.traffic, g, "cpu")
    node = port.make_node(port.port_spec(cell.config), cell.config,
                          dict(cell.traffic, overlap=0), tree, "cpu")
    p = ref.to_torch(tree, cell.config, "cpu")
    with port.head_context(cell.config):
        got = node(left[0], right[0])
    want = ref.forward(p, cell.config,
                       ref.frames_to_rgb(torch.from_numpy(left[:1])),
                       ref.frames_to_rgb(torch.from_numpy(right[:1])))[0]
    gap = np.abs(got - want.numpy())
    assert 0 < gap.mean() < BF16_MEAN_GAP.get(name, 0.1)


def test_packed_cell_runs_the_packed_head(monkeypatch):
    """The packed configuration's node takes the program's packed 3D head
    under `port.head_context`, and the fused one does not."""
    from redtail_tpu_torch.models.stereo import StereoNet
    calls = []
    real = StereoNet._volume_head_packed

    def spy(self, *args):
        calls.append(self.spec.name)
        return real(self, *args)
    monkeypatch.setattr(StereoNet, "_volume_head_packed", spy)
    for name, want in (("nvsmall.serve", 0), ("nvsmall.serve.packed", 1)):
        cell, g, tree = _setup(name)
        left, right, _ = data.make_frames(cell.config, cell.traffic, g,
                                          "cpu")
        node = port.make_node(port.port_spec(cell.config), cell.config,
                              dict(cell.traffic, overlap=0), tree, "cpu")
        calls.clear()
        with port.head_context(cell.config):
            node(left[0], right[0])
        assert len(calls) == want, name


@pytest.mark.parametrize("name", ["resnet18_3d.train", CORR])
def test_train_step_fp32(name):
    cell = tiny_cell("resnet18_3d.train")
    if name == CORR:
        cell.config = dict(tiny_corr_config(), train=cell.config["train"])
    g = data.generator(5, "cpu")
    tree = data.make_weights(cell.config, g, "cpu")
    batches = data.make_batches(cell.config, cell.traffic, g, "cpu")
    config = dict(cell.config, dtype="float32")
    trainer = port.PortTrainer(port.port_spec(config), config, cell.traffic,
                               tree, "cpu")
    before = {k: v.detach().clone() for k, v in trainer.leaves().items()}
    loss = float(trainer.step(batches[0]))
    grads = {k: float(torch.linalg.vector_norm(v.double()))
             for k, v in trainer.first_grads().items()}
    change = {k: float(torch.linalg.vector_norm((v.detach() - before[k])
                                                .double()))
              for k, v in trainer.leaves().items()}
    want = ref.train(config, tree, batches[:1], steps=1, device="cpu",
                     lr=config["train"]["lr"])
    assert abs(loss - want["losses"][0]) < 1e-5 * abs(want["losses"][0])
    assert set(grads) == set(want["grad_norms"])
    median = np.median(list(want["grad_norms"].values()))
    for k, v in want["grad_norms"].items():
        assert abs(grads[k] - v) <= 1e-4 * max(v, median), k
    for k, v in want["change_norms"].items():
        if want["grad_norms"][k] >= 1e-3 * median:
            assert abs(change[k] - v) <= 1e-3 * v, k


def test_train_batches_differ_by_crop():
    cell = tiny_cell("resnet18_3d.train")
    g = data.generator(7, "cpu")
    data.make_weights(cell.config, g, "cpu")
    batches = data.make_batches(cell.config, cell.traffic, g, "cpu")
    assert len(batches) == TRAIN["pool"]
    left, right, target, valid = batches[0]
    assert left.shape == (TRAIN["batch"], *TRAIN["crop"], 3)
    top = 2 * cell.config["max_disp"]
    assert 0 <= float(target.min()) and float(target.max()) < top
    assert not torch.equal(batches[0][0], batches[1][0])
    assert 0.6 < float(valid.mean()) < 0.8


def test_same_seed_same_inputs():
    cell = tiny_cell("nvsmall.serve")
    a, b = (data.make_weights(cell.config, data.generator(2 ** 33 + 1, "cpu"),
                              "cpu") for _ in range(2))
    assert np.array_equal(ref.leaf(a, "encoder3D/conv3D_1")["weights"],
                          ref.leaf(b, "encoder3D/conv3D_1")["weights"])
