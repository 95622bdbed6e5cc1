"""The H-packed towers and correlation head image-sharded, and the tower
forms under disparity mode (`ops/packed2d.py`, `models/stereo.py`,
`parallel/sharding.py`), on the CPU in gloo ranks spawned by
`parallel/launch.py`.

Two spawns, one of 2 ranks and one of 4, each running many cases
(`rank_checks.run_cases`):

- **ops**: every op of `ops/packed2d.py` on this rank's slots inside an
  image `sharded_axis` (the stem, the flip conv aligned in and shifted
  in, the keep conv with 1 and 2 channel blocks, the unpack, the grouped
  corr soft-argmax) against the same op unsharded, within 1e-5 (absolute
  and relative: the halo slab's sums may take another order), at
  ``h`` = 3, 5 and 17 rows: on 4 ranks some shards hold one slot and some
  none; each rank's pad rows (out-of-image rows of its global slots) are
  exact zeros;
- **forwards**: ResNet18-2D at 33x65 on s2d frames (17 s2d rows, 9
  slots) under the H-packed towers (``hp``) and the H-packed head
  (``hp+corr``), image mode on meshes (1, 2) and (1, 4), against the JAX
  package's unsharded `stereo_forward` under the same ``REDTAIL_TPU_*``
  switches within the sharding tests' 2e-4 (sigmoid units); ResNet-18 3D
  under ``hp`` in image mode (the fused head) and in disparity mode,
  within 1e-3 px of JAX's. Each rank reports the towers' form it took.

Seeded numpy inputs, random biases, weights conditioned as
`tests/test_torch_stereo.py`'s.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from redtail_tpu.models import STEREO_SPECS as JSPECS
from redtail_tpu.models import stereo_forward as jstereo_forward

from redtail_tpu_torch.models import STEREO_SPECS, init_stereo_params
from redtail_tpu_torch.models import params_from_numpy
from redtail_tpu_torch.models.stereo import plain_volume_head
from redtail_tpu_torch.ops import packed2d as P2
from redtail_tpu_torch.ops.halo import owned
from redtail_tpu_torch.ops.space_to_depth import space_to_depth2_np
from redtail_tpu_torch.parallel import rank_checks
from redtail_tpu_torch.parallel.launch import spawn_ranks
from redtail_tpu_torch.runtime import layer_profiler as lp
from test_torch_stereo import conditioned

SWITCHES = ("REDTAIL_TPU_FUSED_TOWERS", "REDTAIL_TPU_HPACK2D",
            "REDTAIL_TPU_HPACK_CORR")
FORMS = {"hp": ("1", "1"), "hp+corr": ("1", "1", "1")}
HW, MAX_DISP = (33, 65), 8
ATOL_2D = 2e-4   # sigmoid units: tests/test_parallel.py's sharded gate
ATOL_3D = 1e-3   # px: the 3D slice's parity gate
OP_TOL = 1e-5
OP_H = (3, 5, 17)
W, C = 6, 4      # the ops' width and channels per parity


def _env(form):
    return dict(zip(SWITCHES, FORMS[form]))


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


def _forward_cases(ranks):
    """(id, model, tower form, mode, mesh) of the forwards on ``ranks``
    ranks; each is held against JAX's unsharded forward of its model and
    form (`_jax_reference`)."""
    mesh = (1, ranks)
    cases = []
    for form in ("hp", "hp+corr"):
        cases.append((f"resnet18_2d-{form}-image-1x{ranks}", "resnet18_2d",
                      form, "image", mesh))
    cases.append((f"resnet18-hp-image-1x{ranks}", "resnet18", "hp",
                  "image", mesh))
    cases.append((f"resnet18-hp-disparity-1x{ranks}", "resnet18",
                  "hp", "disparity", mesh))
    return cases


FORWARD_CASES = _forward_cases(2) + _forward_cases(4)


def _model(name):
    spec = dataclasses.replace(STEREO_SPECS[name], input_hw=HW,
                               max_disp=MAX_DISP)
    frames = np.random.RandomState(9)
    left, right = (space_to_depth2_np(frames.rand(1, *HW, 3).astype(
        np.float32)) for _ in range(2))
    return spec, conditioned(init_stereo_params(spec, seed=1)), left, right


def _jax_reference(name, form, params, left, right):
    jspec = dataclasses.replace(JSPECS[name], input_hw=HW,
                                max_disp=MAX_DISP)
    with pytest.MonkeyPatch.context() as mp:   # JAX reads them at trace
        for var, value in _env(form).items():
            mp.setenv(var, value)
        fn = jax.jit(lambda p, a, b: jstereo_forward(jspec, p, a, b))
        return np.asarray(fn(jax.tree.map(jnp.asarray, params), left,
                             right))


@pytest.fixture(scope="module")
def runs():
    """Both spawns and JAX's references: {ranks: (op results, forward
    results)}, {(model, form): reference}."""
    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, 2))
    mp = pytest.MonkeyPatch()
    for var in SWITCHES + ("REDTAIL_TPU_PACKED3D", "REDTAIL_TPU_DFOLD",
                           "REDTAIL_TPU_PALLAS_CONV3D"):
        mp.delenv(var, raising=False)
    try:
        models = {name: _model(name) for name in ("resnet18_2d",
                                                  "resnet18")}
        refs = {(name, form): _jax_reference(name, form, *models[name][1:])
                for _, name, form, _, _ in FORWARD_CASES}
        results = {}
        for ranks in (2, 4):
            fwd = []
            for _, name, form, mode, mesh in _forward_cases(ranks):
                spec, params, left, right = models[name]
                fwd.append({"spec": {"name": name, "input_hw": HW,
                                     "max_disp": MAX_DISP},
                            "params": params, "left": left, "right": right,
                            "mesh": mesh, "mode": mode, "env": _env(form)})
            groups = {"op": [c for _, c, *_ in OP_CASES], "forward": fwd}
            out = spawn_ranks(rank_checks.run_cases, ranks, backend="gloo",
                              device_type="cpu", args=(groups, "cpu"))
            results[ranks] = ([r["op"] for r in out],
                              [r["forward"] for r in out])
        yield results, refs
    finally:
        mp.undo()
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
    (results, _), (_, case, size, shifted, blocks) = runs, OP_CASES[i]
    want = _unsharded(case)
    assert want.shape[1] == size
    h = case["kwargs"].get("h", case["kwargs"].get("h_half"))
    pads = _pad_rows(size, h, shifted)
    for rank, res in enumerate(results[ranks][0]):
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


@pytest.mark.parametrize("i", range(len(FORWARD_CASES)),
                         ids=[c[0] for c in FORWARD_CASES])
def test_sharded_hpacked_forward_matches_jax(runs, i):
    (results, refs), (_, name, form, mode, mesh) = runs, FORWARD_CASES[i]
    ranks = mesh[1]
    j = [c[0] for c in _forward_cases(ranks)].index(FORWARD_CASES[i][0])
    want = refs[(name, form)]
    atol = ATOL_2D if name == "resnet18_2d" else ATOL_3D
    for rank, res in enumerate(results[ranks][1]):
        got = res[j]
        assert got["tower_form"] == "hp", rank
        assert got["disp"].shape == want.shape, rank
        np.testing.assert_allclose(got["disp"], want, atol=atol, rtol=0,
                                   err_msg=f"rank {rank}")
        # an image-sharded forward exchanged halos; disparity mode's
        # towers ran whole (its exchanges are the 3D stack's)
        assert got["moved_bytes"] > 0, rank
    for res in results[ranks][1][1:]:
        np.testing.assert_array_equal(res[j]["disp"],
                                      results[ranks][1][0][j]["disp"])


def test_disparity_plan_names_the_tower_form(monkeypatch):
    """Disparity mode's forward on one rank (`plain_volume_head`): the
    towers under the caller's switches (the H-packed names), the volume
    and the 3D stack plain (the explicit volume, no fused conv3D_1)."""
    for var in SWITCHES + ("REDTAIL_TPU_PACKED3D",):
        monkeypatch.delenv(var, raising=False)
    for var, value in _env("hp").items():
        monkeypatch.setenv(var, value)
    spec, params, left, right = _model("resnet18")
    net = params_from_numpy(spec, params, device="cpu")
    with torch.inference_mode(), plain_volume_head():
        entries, _ = lp.stereo_layer_plan(net, torch.from_numpy(left),
                                          torch.from_numpy(right))
    names = [n for n, *_ in entries]
    assert "towers_conv1[hp]" in names and "towers_unpack[hp]" in names
    assert "cost_volume" in names and spec.enc3d[0].name in names
    assert not any(n.startswith("cost_volume+") for n in names)

