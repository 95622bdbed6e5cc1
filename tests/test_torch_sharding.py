"""Multi-device forwards of the port (`redtail_tpu_torch/parallel/`) on the
CPU, in gloo ranks spawned by `parallel/launch.py`, against the JAX
package and the port's own unsharded ops.

One spawn per group of checks (a spawn of 4 ranks costs seconds); the
ranks run the programs of `parallel/rank_checks.py` and hand back numpy.

- `make_mesh`: JAX's defaults (all ranks on data, a missing size derived)
  and its ValueError;
- the halo exchange alone: a sharded conv (kernels 3 and 5, strides 1 and
  2), a transposed conv (H, and D of a 3D conv) on global sizes whose
  shards include empty and one-row ones, against the unsharded conv, its
  output and the gradients of a linear loss (dx and dw), fp32, within
  1e-5 (absolute and relative: sums of another order);
- image mode (N over data, H over spatial) for ResNet18-2D and NVTiny at
  32x64 (and 33x64, odd H), max_disp 4, raw and s2d frames, mesh (2, 2)
  and (1, 4), against JAX's unsharded `stereo_forward` at atol 2e-4 (the
  tolerance of `tests/test_parallel.py`), ResNet18-2D's residual weights
  scaled by 0.3 and every bias random; NVTiny under the plain lowering
  there, and at max_disp 8 under the fused head, the packed head (its
  final deconv the unpack branch) and the packed head with
  ``REDTAIL_TPU_DFOLD=1``, each against JAX's unsharded forward under the
  same switches;
- disparity mode, NVTiny max_disp 8 on mesh (1, 4) (D = 8 over 4 ranks,
  halved to 4 and 2 by the strided layers: shards of 1 and 0), against
  JAX at 2e-4;
- ResNet-18's towers at 33x65 on s2d frames, max_disp 8, on 2 and 4
  spatial ranks (meshes (2, 2) and (1, 4)): ResNet18-2D in image mode,
  ResNet-18 3D in image mode under the fused head and in disparity mode,
  against JAX at 2e-4;
- the correlation model under disparity sharding raises.
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
from redtail_tpu_torch.ops import convolution as conv
from redtail_tpu_torch.ops.space_to_depth import space_to_depth2_np
from redtail_tpu_torch.parallel import (batch_sharding, local_shard,
                                        rank_checks, replicate,
                                        shard_stereo_forward)
from redtail_tpu_torch.ops.halo import owned, plan
from redtail_tpu_torch.parallel.launch import spawn_ranks

RANKS = 4
ATOL = 2e-4  # tests/test_parallel.py's sharded-forward tolerance


def _spawn(target, cases, ranks=RANKS):
    return spawn_ranks(target, ranks, backend="gloo", device_type="cpu",
                       args=(cases, "cpu"))


def conditioned(params, seed=7):
    """Random biases; ResNet18-2D's residual-branch and feature-head
    weights scaled by 0.3 so its correlation volume is O(1)."""
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


# ---------------------------------------------------------------- meshes

MESH_CASES = [({}, (4, 1)), ({"data": 2}, (2, 2)), ({"spatial": 4}, (1, 4)),
              ({"data": 1, "spatial": 4}, (1, 4)),
              ({"data": 3, "spatial": 2}, "mesh 3x2 != 4 devices")]


@pytest.fixture(scope="module")
def meshes():
    return _spawn(rank_checks.mesh_cases, [c for c, _ in MESH_CASES])


@pytest.mark.parametrize("i", range(len(MESH_CASES)),
                         ids=[str(c) for c, _ in MESH_CASES])
def test_make_mesh_defaults_and_error(meshes, i):
    kwargs, want = MESH_CASES[i]
    for rank, results in enumerate(meshes):
        got = results[i]
        if isinstance(want, str):
            assert got["error"] == "ValueError" and got["message"] == want
            continue
        assert got["shape"] == want and got["names"] == ("data", "spatial")
        # row-major over the ranks, as JAX reshapes its device list
        assert got["coords"] == divmod(rank, want[1])


def test_placements_and_local_shard():
    """The layouts are DTensor placements; a shard is cut by the ownership
    rule (no process group needed for the placements)."""
    from torch.distributed.tensor import Replicate, Shard

    assert batch_sharding(None) == (Shard(0), Shard(1))
    assert batch_sharding(None, spatial_dim=None) == (Shard(0), Replicate())
    assert replicate(None) == (Replicate(), Replicate())

    class Mesh:  # the two calls local_shard makes of a DeviceMesh
        def size(self, i):
            return (2, 3)[i]

        def get_local_rank(self, i):
            return (1, 2)[i]

    x = np.arange(4 * 7).reshape(4, 7)
    got = local_shard(Mesh(), x, (Shard(0), Shard(1)))
    np.testing.assert_array_equal(got, x[2:4, 4:7])
    assert [owned(7, 3, r) for r in range(3)] == [(0, 2), (2, 4), (4, 7)]
    assert [owned(2, 4, r) for r in range(4)] == [(0, 0), (0, 1), (1, 1),
                                                  (1, 2)]


def test_plan_sends_halo_rows_not_shards():
    """Neighbours' halos of one row travel as 2-row slabs; shards no
    larger than the slab travel whole."""
    need = tuple((lo - 1, hi + 1) for lo, hi in
                 (owned(64, 4, r) for r in range(4)))
    p = plan(64, 4, need)
    assert (p.whole, p.t, p.rows) == (False, 1, 2)
    need = tuple((lo - 1, hi + 1) for lo, hi in
                 (owned(3, 4, r) for r in range(4)))
    assert plan(3, 4, need).whole


# ------------------------------------------------------------ halo alone


def _conv_case(rs, *, h, k, stride, transposed=False, axis=-2):
    """A sharded conv over global size h on ``axis``: x, w, the loss
    weights g over the output, and the unsharded reference (y, dx, dw)."""
    three_d = axis == -3
    c_in, c_out = 3, 2
    if three_d:
        shape = (2, c_in, h, 4, 5)
    else:
        shape = (2, c_in, h, 6)
    if transposed:
        out_spatial = tuple(2 * v - (v % 2 if i == 0 else 0)
                            for i, v in enumerate(shape[2:]))
        x = rs.randn(*shape).astype(np.float32)
        w = rs.randn(c_in, c_out, *(k,) * (len(shape) - 2)).astype(
            np.float32)
    else:
        x = rs.randn(*shape).astype(np.float32)
        w = rs.randn(c_out, c_in, *(k,) * (len(shape) - 2)).astype(
            np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    nd = xt.dim() - 2
    if transposed:
        y = conv._conv_transpose(xt, wt, None, out_spatial, stride, "SAME")
    else:
        y = conv._conv(xt, wt, None, (stride,) * nd, "SAME")
    g = rs.randn(*y.shape).astype(np.float32)
    (y * torch.from_numpy(g)).sum().backward()
    case = {"x": x, "w": w, "g": g, "stride": stride, "axis": axis,
            "transposed": transposed}
    if transposed:
        case["out_spatial"] = out_spatial
    return case, (y.detach().numpy(), xt.grad.numpy(), wt.grad.numpy())


def _conv_specs():
    specs = []
    # global sizes 3 (shards 0, 1, 1, 1), 9 (2, 2, 2, 3), 18 (4, 5, 4, 5)
    for h in (3, 9, 18):
        for k in (3, 5):
            for stride in (1, 2):
                specs.append((f"conv2d h{h} k{k} s{stride}",
                              dict(h=h, k=k, stride=stride)))
        specs.append((f"deconv2d h{h} k3 s2",
                      dict(h=h, k=3, stride=2, transposed=True)))
    for h in (2, 5):  # D of a 3D conv: 2 over 4 ranks holds 0, 1, 0, 1
        specs.append((f"conv3d d{h} k3 s2", dict(h=h, k=3, stride=2,
                                                 axis=-3)))
        specs.append((f"deconv3d d{h} k3 s2",
                      dict(h=h, k=3, stride=2, transposed=True, axis=-3)))
    return specs


CONV_SPECS = _conv_specs()


@pytest.fixture(scope="module")
def convs():
    rs = np.random.RandomState(0)
    cases = [(name, *_conv_case(rs, **kw)) for name, kw in CONV_SPECS]
    results = _spawn(rank_checks.conv_cases, [c for _, c, _ in cases])
    return {name: (case, want, [r[i] for r in results])
            for i, (name, case, want) in enumerate(cases)}


@pytest.mark.parametrize("name", [name for name, _ in CONV_SPECS])
def test_halo_exchange_conv_matches_unsharded(convs, name):
    case, (y, dx, dw), ranks = convs[name]
    axis = case["axis"] % y.ndim
    got_y = np.concatenate([r["y"] for r in ranks], axis=axis)
    got_dx = np.concatenate([r["dx"] for r in ranks], axis=axis)
    # the ranks' own rows tile the global output and input
    assert [r["y"].shape[axis] for r in ranks] == [
        hi - lo for lo, hi in (owned(y.shape[axis], RANKS, r)
                               for r in range(RANKS))]
    np.testing.assert_allclose(got_y, y, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got_dx, dx, atol=1e-5, rtol=1e-5)
    # each rank holds its part of the weight gradient; they sum to it
    np.testing.assert_allclose(sum(r["dw"] for r in ranks), dw, atol=1e-4,
                               rtol=1e-5)


# --------------------------------------------------------- the forwards


def _frames(hw, n, seed):
    rs = np.random.RandomState(seed)
    return tuple(rs.rand(n, *hw, 3).astype(np.float32) for _ in range(2))


def _jax_forward(name, hw, max_disp, params, left, right):
    jspec = dataclasses.replace(JSPECS[name], input_hw=hw,
                                max_disp=max_disp)
    fn = jax.jit(lambda p, l, r: jstereo_forward(jspec, p, l, r))
    return np.asarray(fn(jax.tree.map(jnp.asarray, params), left, right))


# (model, frames hw, max_disp, s2d, mesh, mode, lowering): the 3D model's
# head on both sides (`rank_checks.lowering`; JAX's switches are the
# REDTAIL_TPU_PACKED3D / _DFOLD environment, its default head the fused
# one); "plain" against JAX's fused head, the same function
FORWARDS = [
    ("resnet18_2d", (32, 64), 4, False, (2, 2), "image", "fused"),
    ("resnet18_2d", (33, 64), 4, False, (2, 2), "image", "fused"),
    ("resnet18_2d", (33, 64), 4, True, (2, 2), "image", "fused"),
    ("resnet18_2d", (33, 64), 4, False, (1, 4), "image", "fused"),
    ("nvtiny", (32, 64), 4, False, (2, 2), "image", "plain"),
    ("nvtiny", (33, 64), 4, False, (2, 2), "image", "plain"),
    ("nvtiny", (33, 64), 4, True, (2, 2), "image", "plain"),
    ("nvtiny", (33, 64), 4, False, (1, 4), "image", "plain"),
    ("nvtiny", (32, 64), 8, False, (1, 4), "disparity", "plain"),
    ("nvtiny", (33, 64), 8, True, (1, 4), "disparity", "plain"),
] + [("nvtiny", hw, 8, s2d, mesh, "image", lowering)
     for lowering in ("fused", "packed", "packed+dfold")
     for hw, s2d, mesh in (((32, 64), False, (2, 2)),
                           ((33, 64), False, (2, 2)),
                           ((33, 64), True, (2, 2)),
                           ((33, 64), False, (1, 4)),
                           ((32, 64), True, (1, 4)))]
# ResNet-18's towers (the 2N batch) on s2d frames at 33x65 on 2 and 4
# spatial ranks: ResNet18-2D in image mode, ResNet-18 3D in image mode
# under the fused head and in disparity mode
FORWARDS += [(name, (33, 65), 8, True, mesh, mode, lowering)
             for name, mode, lowering in (
                 ("resnet18_2d", "image", "fused"),
                 ("resnet18", "image", "fused"),
                 ("resnet18", "disparity", "plain"))
             for mesh in ((2, 2), (1, 4))]
FORWARD_IDS = [f"{m}-{hw[0]}x{hw[1]}-d{d}-{'s2d' if s else 'raw'}-"
               f"{mesh[0]}x{mesh[1]}-{mode}"
               + ("" if (m, low, d) in (("resnet18_2d", "fused", 4),
                                        ("nvtiny", "plain", 4))
                  or mode == "disparity" else f"-{low}")
               for m, hw, d, s, mesh, mode, low in FORWARDS]


@pytest.fixture(scope="module")
def forwards(monkeypatch_module):
    for var in ("REDTAIL_TPU_PALLAS_CONV3D", "REDTAIL_TPU_PACKED3D",
                "REDTAIL_TPU_DFOLD"):
        monkeypatch_module.delenv(var, raising=False)
    cases, wants = [], []
    for i, (name, hw, max_disp, s2d, mesh, mode, lowering) in enumerate(
            FORWARDS):
        spec = dataclasses.replace(STEREO_SPECS[name], input_hw=hw,
                                   max_disp=max_disp)
        params = conditioned(init_stereo_params(spec, seed=1))
        left, right = _frames(hw, 2, seed=i)
        if s2d:
            left, right = space_to_depth2_np(left), space_to_depth2_np(right)
        with pytest.MonkeyPatch.context() as mp:   # JAX's switches
            mp.setenv("REDTAIL_TPU_PACKED3D", "1" if (
                lowering.startswith("packed")) else "0")
            mp.setenv("REDTAIL_TPU_DFOLD", "1" if (
                lowering == "packed+dfold") else "0")
            wants.append(_jax_forward(name, hw, max_disp, params, left,
                                      right))
        cases.append({"spec": {"name": name, "input_hw": hw,
                               "max_disp": max_disp},
                      "params": params, "left": left, "right": right,
                      "mesh": mesh, "mode": mode, "lowering": lowering})
    results = _spawn(rank_checks.forward_cases, cases)
    return wants, results


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


@pytest.mark.parametrize("i", range(len(FORWARDS)), ids=FORWARD_IDS)
def test_sharded_forward_matches_jax(forwards, i):
    wants, results = forwards
    want = wants[i]
    for rank, res in enumerate(results):
        got = res[i]["disp"]
        assert got.shape == want.shape, rank
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0,
                                   err_msg=f"rank {rank}")
    # every rank got the same map back
    for res in results[1:]:
        np.testing.assert_array_equal(res[i]["disp"], results[0][i]["disp"])


def test_disparity_mode_refuses_corr_and_unknown_modes():
    spec = dataclasses.replace(STEREO_SPECS["resnet18_2d"], input_hw=(32, 64),
                               max_disp=4)
    with pytest.raises(ValueError, match="3D cost-volume"):
        shard_stereo_forward(spec, None, None, mode="disparity")
    with pytest.raises(ValueError, match="unknown sharding mode"):
        shard_stereo_forward(spec, None, None, mode="rows")


class OneRankMesh:
    """The calls the sharded forward makes of a (1, 1) `DeviceMesh` on
    ``device_type``: no collective runs."""

    def __init__(self, device_type):
        self.device_type = device_type

    def size(self, i):
        return 1

    def get_local_rank(self, i):
        return 0


def test_sharded_forward_runs_on_the_meshs_device(monkeypatch):
    """Numpy frames and a numpy tree go to the mesh's device: the CPU for a
    CPU mesh; for a CUDA mesh (CUDA faked available, card 1 current) the
    card, which this CPU-only torch cannot reach, so the forward fails
    there instead of running on the CPU. Tensors and nets on another kind
    of device raise."""
    from redtail_tpu_torch.models import params_from_numpy
    from redtail_tpu_torch.parallel import sharding

    spec = dataclasses.replace(STEREO_SPECS["nvtiny"], input_hw=(32, 64),
                               max_disp=4)
    params = init_stereo_params(spec, seed=1)
    left, right = _frames((32, 64), 1, seed=0)
    fn = shard_stereo_forward(spec, params, OneRankMesh("cpu"))
    assert fn(None, left, right).device == torch.device("cpu")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    mesh = OneRankMesh("cuda")
    assert sharding.mesh_device(mesh) == torch.device("cuda", 1)
    fn = shard_stereo_forward(spec, params, mesh)
    with pytest.raises(AssertionError, match="not compiled with CUDA"):
        fn(None, left, right)
    with pytest.raises(ValueError, match="frame on cpu for a mesh on cuda"):
        fn(None, torch.from_numpy(left), torch.from_numpy(right))
    net = params_from_numpy(spec, params, device="cpu")
    with pytest.raises(ValueError, match="params on cpu for a mesh on cuda"):
        shard_stereo_forward(spec, net, mesh)(None, left, right)


def test_corr_model_under_disparity_sharding_raises():
    """The one sharded forward a net refuses: the correlation model has no
    disparity axis to split."""
    spec = dataclasses.replace(STEREO_SPECS["resnet18_2d"], input_hw=(32, 64),
                               max_disp=4)
    left, right = _frames((32, 64), 1, seed=0)
    case = {"spec": {"name": "resnet18_2d", "input_hw": (32, 64),
                     "max_disp": 4},
            "params": init_stereo_params(spec, seed=1), "left": left,
            "right": right, "axis": -3, "size": 4}
    for res in _spawn(rank_checks.refused_cases, [case], ranks=2):
        assert res[0]["error"] == "ValueError"
        assert "3D cost-volume" in res[0]["message"]


def test_a_failing_rank_fails_the_spawn_with_its_traceback():
    with pytest.raises(Exception, match="(?s)TypeError.*bogus"):
        _spawn(rank_checks.mesh_cases, [{"bogus": 1}], ranks=2)


def test_init_from_env_joins_a_launchers_group(monkeypatch):
    """`torchrun`'s environment (a one-rank group on localhost)."""
    import socket

    import torch.distributed as dist
    from redtail_tpu_torch.parallel.launch import init_from_env

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for k, v in {"RANK": "0", "LOCAL_RANK": "0", "WORLD_SIZE": "1",
                 "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}.items():
        monkeypatch.setenv(k, v)
    device = init_from_env("gloo", "cpu")
    try:
        assert device == torch.device("cpu")
        assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
    finally:
        dist.destroy_process_group()
    with pytest.raises(ValueError, match="nccl runs CUDA ranks only"):
        init_from_env("nccl", "cpu")
