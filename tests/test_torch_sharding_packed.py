"""The ops of the fused and packed 3D heads sharded along the image rows
(`ops/packed3d.py`, `ops/convolution.py:conv3d_transpose_dfold`,
`ops/fused_cost_volume_conv.py`), and int8 leaves in image mode, on the
CPU in gloo ranks spawned by `parallel/launch.py`.

- Op level: each packed op (`conv3d_packed` in both conventions,
  H-packed or not, the in-shifted H-packed form being conv223's plain
  version here; `conv3d_packed_down`, `conv3d_packed_down_unpack`,
  `deconv3d_packed`, `unpack_conv`), dfold (D- and DH-packed, both
  layouts, the fused soft-argmin) and the emission (both layouts, random
  biases: the boundary-slot fault `tests/test_packed3d.py` records wrote
  elu(bias) into the zero slots) run on 4 ranks, each on its own rows or
  slots of axis 2 (H or its slots; the emission's maps by H), against the
  same op unsharded. Even and odd H give shards of one slot and empty
  ones. fp32, forward only (these heads have no gradient in either
  package), within 1e-5 absolute and relative (the CPU convs over a slab
  may sum in another order).
- Int8: ResNet18-2D and NVTiny int8 trees (JAX's calibration, as
  `tests/test_torch_quant_stereo.py`) through `shard_stereo_forward` in
  image mode, raw frames, meshes (2, 2) and (1, 4), even and odd H,
  against the port's unsharded int8 forward at that file's tolerances
  (1e-4 sigmoid units, 1e-3 px) and no farther than it from JAX's
  unsharded eager int8 forward, every rank the same map.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from redtail_tpu.models import STEREO_SPECS as JSPECS
from redtail_tpu.models import stereo as jstereo
from redtail_tpu.quant import stereo_int8 as jint8

from redtail_tpu_torch.models import STEREO_SPECS, init_stereo_params
from redtail_tpu_torch.ops import packed3d as P
from redtail_tpu_torch.ops.halo import owned
from redtail_tpu_torch.parallel import rank_checks
from redtail_tpu_torch.parallel.launch import spawn_ranks
from redtail_tpu_torch.quant import stereo_int8
from test_torch_quant import _jax_tree
from test_torch_sharding import conditioned

RANKS = 4
TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """A few intra-op threads, so that parallel test workers do not
    oversubscribe the cores (restored after)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, 2))
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module", autouse=True)
def clean_env():
    mp = pytest.MonkeyPatch()
    for var in ("REDTAIL_TPU_PACKED3D", "REDTAIL_TPU_DFOLD",
                "REDTAIL_TPU_PALLAS_CONV3D", "REDTAIL_TPU_MASK_FORM",
                "REDTAIL_TPU_MASK_MUL"):
        mp.delenv(var, raising=False)
    yield
    mp.undo()


def _spawn(target, cases):
    return spawn_ranks(target, RANKS, backend="gloo", device_type="cpu",
                       args=(cases, "cpu"))


# ------------------------------------------------------------- op level


def _rand(rs, *shape, scale=1.0):
    return (rs.randn(*shape) * scale).astype(np.float32)


def _packed(rs, dhw, c, *, h, shifted=False):
    """A packed NDHWC input made by `pack` (zeros in its padding slots)."""
    x = torch.from_numpy(_rand(rs, 1, *dhw, c))
    return P.pack(x, d=True, h=h, shifted=shifted).numpy()


def _op_specs():
    """(id, case) for `rank_checks.op_cases`: ``axis`` 2 of NDHWC (H or
    its slots), 1 of the emission's NHWC maps."""
    rs = np.random.RandomState(0)
    specs = []
    w = _rand(rs, 3, 3, 3, 2, 3, scale=0.3)
    b = _rand(rs, 3, scale=0.1)
    for h in (2, 6, 7, 13):   # slots (aligned / shifted): 1/2, 3/4, 4/5, 7/8
        dhw = (5, h, 4)
        for packed_h in (True, False):
            for shifted in (True, False):
                specs.append((
                    f"conv3d_packed h{h} {'dh' if packed_h else 'd'} "
                    f"{'in-shifted' if shifted else 'aligned-in'}",
                    dict(op="conv3d_packed",
                         args=[_packed(rs, dhw, 2, h=packed_h,
                                       shifted=shifted), w, b],
                         kwargs=dict(full_spatial=dhw, packed_h=packed_h,
                                     in_shifted=shifted))))
            specs.append((
                f"conv3d_packed_down h{h} {'dh' if packed_h else 'd'}",
                dict(op="conv3d_packed_down",
                     args=[_packed(rs, dhw, 2, h=packed_h), w, b],
                     kwargs=dict(full_spatial=dhw, packed_h=packed_h))))
            specs.append((
                f"unpack_conv h{h} {'dh' if packed_h else 'd'}",
                dict(op="unpack_conv", args=[_packed(rs, dhw, 2,
                                                     h=packed_h)],
                     kwargs=dict(full_spatial=dhw, packed_h=packed_h))))
        specs.append((f"conv3d_packed_down_unpack h{h}",
                      dict(op="conv3d_packed_down_unpack",
                           args=[_packed(rs, dhw, 2, h=False), w, b],
                           kwargs=dict(full_spatial=dhw))))
    # deconvs: global out H 3 / 4 (input rows 2: empty shards on 4 ranks),
    # 9, 14
    wt = _rand(rs, 3, 3, 3, 3, 2, scale=0.3)   # (.., Co, Ci)
    for ho in (3, 4, 9, 14):
        out = (6, ho, 7)
        x = _rand(rs, 1, 3, -(-ho // 2), 4, 2)
        for in_packed_d in (True, False):
            xin = (P.pack(torch.from_numpy(x), d=True).numpy()
                   if in_packed_d else x)
            for pack_h in (True, False):
                specs.append((
                    f"deconv3d_packed ho{ho} "
                    f"{'d-packed' if in_packed_d else 'unpacked'}-in "
                    f"{'dh' if pack_h else 'd'}-out",
                    dict(op="deconv3d_packed", args=[xin, wt, b],
                         kwargs=dict(out_spatial=out, in_packed_d=in_packed_d,
                                     pack_h=pack_h))))
    # dfold: out H 5 / 6 (input slots 2), 13, 18; c_out 1 as the heads
    w1 = _rand(rs, 3, 3, 3, 1, 2, scale=0.3)
    b1 = _rand(rs, 1, scale=0.1)
    for ho in (5, 6, 13, 18):
        out = (12, ho, 9)
        x = torch.from_numpy(_rand(rs, 1, 6, -(-ho // 2), 5, 2))
        for h_packed in (True, False):
            xp = P.pack(x, d=True, h=h_packed).numpy()
            for layout, reduce in (("ndhwc", None), ("dlast", None),
                                   ("dlast", "softargmin")):
                specs.append((
                    f"dfold ho{ho} {'dh' if h_packed else 'd'} {layout}"
                    f"{' +softargmin' if reduce else ''}",
                    dict(op="conv3d_transpose_dfold", args=[xp, w1, b1],
                         kwargs=dict(out_spatial=out, d_packed=True,
                                     h_packed=h_packed, layout=layout,
                                     reduce=reduce))))
    # the emission: maps of H rows, slots (H + 1) // 2 + 1 (H = 1: 2, one
    # rank's slab of one row), K = 3, random biases
    we = _rand(rs, 3, 3, 3, 4, 3, scale=0.3)
    be = _rand(rs, 3, scale=0.5)
    for h in (1, 4, 5, 11):
        left, right = _rand(rs, 1, h, 9, 2), _rand(rs, 1, h, 9, 2)
        for emit in ("full", "dh_shifted"):
            specs.append((f"emission h{h} {emit}",
                          dict(op="cost_volume_conv3d",
                               args=[left, right, we, be], sharded=[0, 1],
                               axis=1, kwargs=dict(max_disp=5, act="elu",
                                                   emit=emit))))
    for _, case in specs:
        case.setdefault("sharded", [0])
        case.setdefault("axis", 2)
    return specs


OP_SPECS = _op_specs()


@pytest.fixture(scope="module")
def ops():
    results = _spawn(rank_checks.op_cases, [c for _, c in OP_SPECS])
    return {name: (case, [r[i]["y"] for r in results])
            for i, (name, case) in enumerate(OP_SPECS)}


def _unsharded(case):
    args = [None if a is None else torch.from_numpy(a) for a in case["args"]]
    with torch.no_grad():
        return rank_checks._ops()[case["op"]](
            *args, **rank_checks.op_kwargs(case["kwargs"])).numpy()


@pytest.mark.parametrize("name", [name for name, _ in OP_SPECS])
def test_sharded_op_matches_unsharded(ops, name):
    case, shards = ops[name]
    want = _unsharded(case)
    # the output's rows (or slots) along the sharded axis: H is dim 1 of
    # dfold's dlast output, 2 of every NDHWC one
    axis = 1 if case["kwargs"].get("layout") == "dlast" else 2
    assert [s.shape[axis] for s in shards] == [
        hi - lo for lo, hi in (owned(want.shape[axis], RANKS, r)
                               for r in range(RANKS))]
    got = np.concatenate(shards, axis=axis)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_op_cases_hold_one_slot_and_empty_shards():
    """The sizes above give every op shards of one slot and empty ones."""
    slots = {(h + 1) // 2 for h in (2, 6, 7, 13)} | {
        (h + 1) // 2 + 1 for h in (1, 4, 5, 11)}
    sizes = [[hi - lo for lo, hi in (owned(g, RANKS, r)
                                     for r in range(RANKS))] for g in slots]
    assert any(0 in s for s in sizes) and any(1 in s for s in sizes)


def test_emission_boundary_slots_are_exact_zeros(ops):
    """The dh-shifted emission's global first slot holds row -1 in its
    qh = 0 channels and, for odd H, its last slot holds no row: exact
    zeros on the rank that holds them (the bias is nonzero)."""
    for h in (5, 11):
        case, shards = ops[f"emission h{h} dh_shifted"]
        got = np.concatenate(shards, axis=2)
        k = case["args"][2].shape[-1]
        assert not got[:, :, 0, :, :2 * k].any()
        assert not got[:, :, -1].any()
        assert got[:, :, 1:-1].any()


# ----------------------------------------------------------------- int8

INT8_HW = ((32, 64), (33, 64))
INT8_FORWARDS = [(name, hw, mesh) for name in ("resnet18_2d", "nvtiny")
                 for hw, mesh in ((INT8_HW[0], (2, 2)), (INT8_HW[1], (2, 2)),
                                  (INT8_HW[1], (1, 4)))]


def _int8_tree(name, hw):
    """JAX's calibration on two frame pairs, quantized by the port (equal
    to JAX's tree, `tests/test_torch_quant_stereo.py`)."""
    spec = dataclasses.replace(STEREO_SPECS[name], input_hw=hw, max_disp=4)
    jspec = dataclasses.replace(JSPECS[name], input_hw=hw, max_disp=4)
    params = conditioned(init_stereo_params(spec, seed=0))
    rs = np.random.RandomState(1)
    frames = [(rs.rand(*hw, 3).astype(np.float32),
               rs.rand(*hw, 3).astype(np.float32)) for _ in range(2)]
    scales = jint8.calibrate_stereo(jspec, jax.tree.map(jnp.asarray, params),
                                    frames)
    return jspec, stereo_int8.quantize_stereo_params_int8(params, scales)


@pytest.fixture(scope="module")
def int8_forwards():
    """Per case: two fresh pairs through JAX's eager int8 forward (the
    jitted form fuses the quantize steps and can take the other step, as
    `tests/test_torch_quant_stereo.py` notes), the sharded forward and, on
    rank 0, the port's unsharded forward."""
    cases, wants = [], []
    for i, (name, hw, mesh) in enumerate(INT8_FORWARDS):
        jspec, qtree = _int8_tree(name, hw)
        rs = np.random.RandomState(10 + i)
        left, right = (rs.rand(2, *hw, 3).astype(np.float32)
                       for _ in range(2))
        wants.append(np.asarray(jstereo.stereo_forward(
            jspec, _jax_tree(qtree), jnp.asarray(left), jnp.asarray(right)),
            np.float32))
        base = {"spec": {"name": name, "input_hw": hw, "max_disp": 4},
                "params": qtree, "left": left, "right": right,
                "mode": "image"}
        cases += [dict(base, mesh=mesh), dict(base, unsharded=True)]
    return wants, _spawn(rank_checks.forward_cases, cases)


@pytest.mark.parametrize("i", range(len(INT8_FORWARDS)),
                         ids=[f"{m}-{hw[0]}x{hw[1]}-{mesh[0]}x{mesh[1]}"
                              for m, hw, mesh in INT8_FORWARDS])
def test_int8_image_sharded_forward_matches_jax(int8_forwards, i):
    """Every rank's map against JAX's eager int8 forward: NVTiny within
    1e-3 px on every pixel; ResNet18-2D within 1e-4 sigmoid units on
    every pixel where the port's unsharded int8 forward is, and within
    1e-5 of that forward (sums of another order) on the others. Those lie
    downstream of an input that the two packages quantize to neighbouring
    steps: their fp32 ELUs differ by one ulp on some negative inputs, and
    at 32x64 one activation of the sixth res block lands at 5.4999986
    steps in the port and 5.5000003 in JAX (ROADMAP.md section 3)."""
    wants, results = int8_forwards
    want = wants[i]
    unsharded = results[0][2 * i + 1]["disp"]
    assert unsharded.shape == want.shape
    agree = np.abs(unsharded - want) <= 1e-4
    assert agree.mean() >= 0.5   # 0.90 to 1.0 of the pixels on these seeds
    for rank, res in enumerate(results):
        got = res[2 * i]["disp"]
        assert got.shape == want.shape, rank
        if INT8_FORWARDS[i][0] == "nvtiny":
            np.testing.assert_allclose(got, want, atol=1e-3, rtol=0,
                                       err_msg=f"rank {rank}")
        else:
            np.testing.assert_allclose(got[agree], want[agree], atol=1e-4,
                                       rtol=0, err_msg=f"rank {rank}")
            np.testing.assert_allclose(got[~agree], unsharded[~agree],
                                       atol=TOL, rtol=0,   # sum order
                                       err_msg=f"rank {rank}")
        np.testing.assert_array_equal(got, results[0][2 * i]["disp"])
