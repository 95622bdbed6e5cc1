"""The ops of `ops/packed2d.py` image-sharded, on the CPU in gloo ranks
spawned by `parallel/launch.py`. No model path of the port calls these
ops (its towers run as one batch of 2N); they are the op-level port of the
JAX package's H-packed layout, held here on each rank's slots.

Two spawns, one of 2 ranks and one of 4, each running every op case
(`rank_checks.run_cases`): every op of `ops/packed2d.py` on this rank's
slots inside an image `sharded_axis` (the stem, the flip conv aligned in
and shifted in, the keep conv with 1 and 2 channel blocks, the unpack, the
grouped corr soft-argmax) against the same op unsharded, within 1e-5
(absolute and relative: the halo slab's sums may take another order), at
``h`` = 3, 5 and 17 rows: on 4 ranks some shards hold one slot and some
none; each rank's pad rows (out-of-image rows of its global slots) are
exact zeros.

Seeded numpy inputs.
"""

import numpy as np
import pytest
import torch

from redtail_tpu_torch.ops import packed2d as P2
from redtail_tpu_torch.ops.halo import owned
from redtail_tpu_torch.parallel import rank_checks
from redtail_tpu_torch.parallel.launch import spawn_ranks

OP_TOL = 1e-5
OP_H = (3, 5, 17)
W, C = 6, 4      # the ops' width and channels per parity


def _pad(shape, rs):
    return rs.randn(*shape).astype(np.float32)


def _masked(x, h, shifted):
    """``x`` (N, slots, W, 2C) with its out-of-image rows zeroed, as the
    ops' inputs always are."""
    t = torch.from_numpy(x.copy())
    return P2._mask_rows(t, h, shifted=shifted).numpy()


def _op_cases():
    """(id, op case, global output size of axis 1, shifted out, channel
    blocks or None for rows) for every op and ``h``."""
    rs = np.random.RandomState(3)
    cases = []
    for h in OP_H:
        hp = P2.slots(h)
        aligned = _masked(_pad((1, hp, W, 2 * C), rs), h, False)
        shifted = _masked(_pad((1, hp + 1, W, 2 * C), rs), h, True)
        w, b = _pad((3, 3, C, C), rs), _pad((C,), rs)
        one = [
            ("conv1_s2d_hpacked", [_pad((1, h, W, 12), rs),
                                   _pad((3, 3, 12, C), rs), b], [0],
             {"h_half": h, "act": "elu"}, hp, False, 1),
            ("conv2d_hpacked", [aligned, w, b], [0],
             {"h": h, "in_shifted": False, "act": "elu"}, hp + 1, True, 1),
            ("conv2d_hpacked", [shifted, w, b], [0],
             {"h": h, "in_shifted": True}, hp, False, 1),
            ("conv2d_hpacked_keep", [aligned, w, b], [0], {"h": h}, hp,
             False, 1),
            ("conv2d_hpacked_keep", [aligned, _pad((3, 3, C, 2 * C), rs),
                                     _pad((4 * C,), rs)], [0],
             {"h": h, "blocks": 2}, hp, False, 2),
            ("unpack_h2d", [aligned], [0], {"h": h}, h, False, None),
            ("corr_softargmax_hpacked",
             [aligned, _masked(_pad((1, hp, W, 2 * C), rs), h, False)],
             [0, 1], {"max_disp": 4, "h": h}, hp, False, 1),
        ]
        for op, args, sharded, kwargs, size, shifted_out, blocks in one:
            tag = ("-shifted-in" if kwargs.get("in_shifted")
                   else f"-blocks{blocks}" if op.endswith("keep") else "")
            cases.append((f"{op}{tag}-h{h}",
                          {"op": op, "args": args, "sharded": sharded,
                           "axis": 1, "kwargs": kwargs},
                          size, shifted_out, blocks))
    return cases


OP_CASES = _op_cases()


def _unsharded(case):
    args = [torch.from_numpy(a) for a in case["args"]]
    with torch.no_grad():
        y = rank_checks._ops()[case["op"]](
            *args, **rank_checks.op_kwargs(case["kwargs"]))
    return y.numpy()


@pytest.fixture(scope="module")
def runs():
    """Both spawns' op results: {ranks: [each rank's results]}."""
    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, 2))
    try:
        groups = {"op": [c for _, c, *_ in OP_CASES]}
        yield {ranks: [r["op"] for r in spawn_ranks(
            rank_checks.run_cases, ranks, backend="gloo", device_type="cpu",
            args=(groups, "cpu"))] for ranks in (2, 4)}
    finally:
        torch.set_num_threads(saved)


def _pad_rows(size, h, shifted):
    """(slot, parity) -> its original row is outside [0, h)."""
    lead = 1 if shifted else 0
    row = 2 * np.arange(size)[:, None] + np.arange(2)[None, :] - lead
    return (row < 0) | (row >= h)


@pytest.mark.parametrize("ranks", [2, 4])
@pytest.mark.parametrize("i", range(len(OP_CASES)),
                         ids=[c[0] for c in OP_CASES])
def test_packed2d_op_on_each_ranks_slots(runs, ranks, i):
    _, case, size, shifted, blocks = OP_CASES[i]
    want = _unsharded(case)
    assert want.shape[1] == size
    h = case["kwargs"].get("h", case["kwargs"].get("h_half"))
    pads = _pad_rows(size, h, shifted)
    for rank, res in enumerate(runs[ranks]):
        a, b = owned(size, ranks, rank)
        got = res[i]["y"]
        np.testing.assert_allclose(got, want[:, a:b], atol=OP_TOL,
                                   rtol=OP_TOL, err_msg=f"rank {rank}")
        if blocks is None:
            continue
        # the rank's pad rows: exact zeros, only where its global slot is
        view = got.reshape(*got.shape[:3], blocks, 2,
                           got.shape[-1] // (2 * blocks))
        for slot, q in zip(*np.nonzero(pads[a:b])):
            assert not view[:, slot, :, :, q].any(), (rank, a + slot, q)
