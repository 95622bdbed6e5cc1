"""The existing cells' inputs and reference outputs, pinned: at a test's
size, the SHA-256 of each cell's weights, its pool (frames and shifts, or
batches) and the reference's outputs on it (in fp32 and fp8, on one CPU
thread), recorded before the harness learned the correlation family. A
change to the harness that moves any of them for these cells changes what
the ledger's numbers mean."""

import hashlib

import numpy as np
import pytest
import torch

from portbench.harness import data
from portbench.reference import stereo as ref
from portbench.tests.tiny import tiny_cell

SEED = 2 ** 31 + 2029

PINNED = {
    "nvsmall.serve": {
        "weights":
            "ad63b744f672dbd7686f085f2e144a264d632462f3e02e9900e6fd006c6b86e1",
        "pool":
            "bb68b008938cc4dc7ab084a4083bce0aab9e109fba8e81dba1d1535fa29674ca",
        "reference":
            "513ab45f944f4b834d933c09b3bd3c29c7a589b9cffdfb51419db2a1ff28ef3e",
    },
    "resnet18_3d.serve": {
        "weights":
            "794b0c9ec978c368d66dcbafda19c83379cce4ae600b3695dfe48ea5c904e7cb",
        "pool":
            "cd7a73c173e900eb23430103ab445155b927ea475867591e9f98f4b8aec21e2d",
        "reference":
            "76894d295b6fcaacbe9b114fc7da0591f5573f1ea525c1d408da24c781273ec3",
    },
    "resnet18_3d.cam30": {
        "weights":
            "794b0c9ec978c368d66dcbafda19c83379cce4ae600b3695dfe48ea5c904e7cb",
        "pool":
            "cd7a73c173e900eb23430103ab445155b927ea475867591e9f98f4b8aec21e2d",
        "reference":
            "76894d295b6fcaacbe9b114fc7da0591f5573f1ea525c1d408da24c781273ec3",
    },
    "resnet18_3d.train": {
        "weights":
            "794b0c9ec978c368d66dcbafda19c83379cce4ae600b3695dfe48ea5c904e7cb",
        "pool":
            "f2f04c128db169e4dce6d64b580c837abed36d560b7392e4ecc005d2c1f179db",
        "reference":
            "230f6ab3084d10d85b50eb96b01da8e64d045ee54413f431efd30fa71547742e",
    },
}


def _hash(arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(np.asarray(a))
        h.update(str((a.dtype.str, a.shape)).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _leaves(tree):
    for key in sorted(tree):
        node = tree[key]
        if isinstance(node, dict):
            yield from _leaves(node)
        else:
            yield node


def digests(name: str) -> dict:
    """{"weights", "pool", "reference"} SHA-256 of cell ``name`` at a
    test's size from `SEED`."""
    cell = tiny_cell(name)
    config = cell.config
    torch.set_num_threads(1)  # CPU convs sum in an order of their threads
    g = data.generator(SEED, "cpu")
    tree = data.make_weights(config, g, "cpu")
    p = ref.to_torch(tree, config, "cpu")
    with torch.no_grad():
        if cell.traffic["kind"] == "train_steps":
            batches = data.make_batches(config, cell.traffic, g, "cpu")
            pool = [t.numpy() for b in batches for t in b]
            left, right = batches[0][0], batches[0][1]
            outs = [ref.forward(p, config, left, right).numpy()]
        else:
            left, right, shifts = data.make_frames(config, cell.traffic, g,
                                                   "cpu")
            pool = [left, right, shifts]
            outs = [ref.forward(
                p, config,
                ref.frames_to_rgb(torch.from_numpy(left[k:k + 1])),
                ref.frames_to_rgb(torch.from_numpy(right[k:k + 1])),
                precision).numpy()
                for k in range(2) for precision in ref.PRECISIONS]
    return {"weights": _hash(_leaves(tree)), "pool": _hash(pool),
            "reference": _hash(outs)}


@pytest.mark.parametrize("name", sorted(PINNED))
def test_existing_cells_pinned(name):
    assert digests(name) == PINNED[name]
