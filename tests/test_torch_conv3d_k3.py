"""The 3D encoder's conv + ELU kernel (`redtail_tpu_torch/kernels/
conv3d_k3.py`) on the CPU: its plain version against the JAX package's
`conv3d` + `elu`, the tiling the CUDA kernel mirrors, the model's routing
predicate and the wrapper's refusals. The CUDA kernel is held against the
plain version on the card by `tests/test_torch_cuda.py` and
`chip_smoke.py`.

The routing and the refusals are checked on fake CUDA tensors
(`FakeTensorMode`: shapes, dtypes and devices, no data), which reach the
custom op's shape-only implementation and never a launch.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode

import jax.numpy as jnp

from redtail_tpu.ops.activations import elu as jelu
from redtail_tpu.ops.convolution import conv3d as jconv3d

from redtail_tpu_torch.kernels import _ops
from redtail_tpu_torch.kernels import conv223 as c223
from redtail_tpu_torch.kernels import conv3d_k3 as k3
from redtail_tpu_torch.models import (STEREO_SPECS, init_stereo_params,
                                      params_from_numpy)
from redtail_tpu_torch.ops import convolution as conv
from redtail_tpu_torch.ops.halo import sharded_axis

ATOL = 1e-5  # fp32 on both sides, summation order only


def _rand(shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _case(shape, k_out, seed=0):
    """x (N, D, H, W, C), DHWIO w, bias: He-scaled, so outputs are O(1)
    and about half of them pass through the ELU's negative branch."""
    c = shape[-1]
    return (_rand(shape, seed), _rand((3, 3, 3, c, k_out), seed + 1,
                                      (27 * c) ** -0.5),
            _rand((k_out,), seed + 2, 0.3))


def _kt(w, dtype):
    """DHWIO (3, 3, 3, C, K) -> the kernel's (3, 3, 3, K, C)."""
    return _t(w).transpose(3, 4).contiguous().to(dtype)


def _bf16_steps(got, want):
    """|got - want| in bf16 steps of the larger magnitude, less the fp32
    summation-order allowance."""
    mag = np.maximum(np.abs(got), np.abs(want))
    step = 2.0 ** (np.floor(np.log2(np.maximum(mag, 2.0 ** -120))) - 7)
    return (np.abs(got - want) - ATOL) / step


@pytest.mark.parametrize("shape,k_out", [((1, 4, 5, 7, 16), 16),
                                         ((2, 3, 6, 9, 8), 32),
                                         ((1, 1, 3, 65, 32), 16)], ids=str)
def test_plain_matches_jax_fp32(shape, k_out):
    x, w, b = _case(shape, k_out)
    want = np.asarray(jelu(jconv3d(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(b))))
    got = k3.conv3d_k3(_t(x), _kt(w, torch.float32), _t(b))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("shape,k_out", [((1, 4, 5, 7, 16), 16),
                                         ((1, 3, 6, 9, 32), 64)], ids=str)
def test_plain_matches_jax_bf16_within_a_step(shape, k_out):
    """bf16 on both sides: the fp32 sum, the bias, one rounding, the ELU
    in bf16; every element within one bf16 step."""
    x, w, b = _case(shape, k_out, seed=3)
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    want = np.asarray(jelu(jconv3d(bf(x), bf(w), bf(b))), np.float32)
    got = k3.conv3d_k3(_t(x).bfloat16(), _kt(w, torch.bfloat16),
                       _t(b).bfloat16())
    assert got.dtype == torch.bfloat16
    assert (_bf16_steps(got.float().numpy(), want) <= 1).all()
    assert (want < 0).mean() > 0.2  # the ELU's negative branch is exercised


def test_plain_is_the_models_arithmetic():
    """The plain version is ``elu(conv3d_ncdhw(...))`` on fp32 carriers,
    bit for bit."""
    x, w, b = _case((1, 3, 4, 6, 32), 32, seed=5)
    xb = _t(x).bfloat16()
    kt = _kt(w, torch.bfloat16)
    w_layer = k3.contract_weights(kt).float()      # the layer's carrier
    want = F.elu(conv.conv3d_ncdhw(xb.permute(0, 4, 1, 2, 3), w_layer,
                                   _t(b))).permute(0, 2, 3, 4, 1)
    assert torch.equal(k3.conv3d_k3(xb, kt, _t(b)), want)
    assert torch.equal(k3.kernel_weights(w_layer), kt)


def test_op_fake_and_flops():
    x, kt, b = torch.zeros(2, 3, 4, 5, 16), torch.zeros(3, 3, 3, 32, 16), \
        torch.zeros(32)
    with FakeTensorMode() as mode:
        out = torch.ops.redtail_torch.conv3d_k3(
            mode.from_tensor(x), mode.from_tensor(kt), mode.from_tensor(b))
    assert tuple(out.shape) == (2, 3, 4, 5, 32)
    assert _ops.conv3d_k3_flops(x.shape, kt.shape) == 2 * 27 * 16 * 120 * 32


# The CUDA kernel's tiling (`tile_plan`, mirrored by `decode` and
# `launch<3, ...>` in csrc/conv_wgmma.cuh): the served models' calls, the
# tile edges (W = 33, 63, 64, 65; H not a multiple of 4), batch 2, every C
# and K.
PLAN_SHAPES = [(1, 48, 161, 513, 32, 32), (1, 24, 81, 257, 64, 64),
               (1, 12, 41, 129, 128, 128), (1, 68, 161, 513, 32, 32),
               (1, 5, 11, 33, 128, 128), (2, 2, 6, 63, 16, 64),
               (1, 1, 5, 64, 64, 16), (4, 2, 7, 65, 128, 32)]


def _tiles(plan):
    for t in range(plan.tiles):
        nt, r = divmod(t, plan.planes * plan.per_plane)
        plane, r = divmod(r, plan.per_plane)
        yield (nt, plane) + plan.tile(r)


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
def test_tile_plan_covers_each_output_once(shape):
    n, d, h, w, c, k = shape
    plan = k3.tile_plan(n, d, h, w, c, k)
    hits = np.zeros((plan.n_tiles, n * d, h, w), np.int32)
    for nt, plane, h0, x0, rows, cols in _tiles(plan):
        assert rows * (cols + 2) <= plan.rows * (c223.TW + 2)
        assert rows * cols <= plan.rows * c223.TW and rows <= 256
        hits[nt, plane, h0:h0 + rows, x0:x0 + cols] += 1
    assert (hits == 1).all()
    assert plan.bn == min(max(k, 32), 128) and plan.n_tiles == 1
    assert plan.rows == (8 if plan.bn == 32 else 4)
    assert plan.chunk == (32 if c <= 32 else 64)
    assert plan.steps == 9 * -(-c // plan.chunk)


def test_conv223_plan_is_unchanged():
    """conv223's plan is the shared one at 2 taps and 64-channel chunks."""
    plan = c223.tile_plan(1, 25, 82, 513, 128, 128)
    assert (plan.bn, plan.chunks, plan.hout, plan.planes, plan.edge_rows,
            plan.edge_tiles, plan.taps, plan.chunk, plan.steps, plan.rows) == \
        (128, 2, 81, 24, 81, 1, 2, 64, 8, 4)


def _emulate_kernel(x, kt, bias, plan):
    """The kernel's arithmetic in fp32 on the CPU, tile by tile: each
    K-step's slab as TMA stages it from (x0 - 1, h0 + th - 1, d + td - 1),
    zero outside the tensor and past C up to the chunk, A rows read at the
    tap's pixel offset, B from the K-major weights; then the bias, the
    rounding to x's dtype and the ELU."""
    n, d, h, w, c = x.shape
    kk = kt.shape[3]
    ch = plan.chunk
    # zero fill past every edge TMA can reach
    xz = F.pad(x.float(), (0, ch * plan.chunks - c, 1, 1, 1, plan.rows + 1,
                           1, 1))
    kz = F.pad(kt.float(), (0, ch * plan.chunks - c, 0,
                            plan.n_tiles * plan.bn - kk))
    out = torch.full((n, d, h, w, kk), float("nan"))
    for nt, plane, h0, x0, rows, cols in _tiles(plan):
        b, dd = divmod(plane, d)
        npx = min(rows, plan.hout - h0) * cols
        tile = plan.rows * c223.TW
        acc = torch.zeros((tile, plan.bn))
        m = torch.arange(tile)
        m = torch.where(m < npx, m, torch.zeros_like(m))
        prow = (m // cols) * (cols + 2) + m % cols
        for st in range(plan.steps):
            cc, tap = divmod(st, 9)
            td, th = divmod(tap, 3)
            # padded index i is unpadded i - 1: the box at h0 + th - 1
            slab = xz[b, dd + td, h0 + th:h0 + th + rows,
                      x0:x0 + cols + 2, ch * cc:ch * cc + ch].reshape(-1, ch)
            for tw in range(3):
                bt = kz[td, th, tw, nt * plan.bn:(nt + 1) * plan.bn,
                        ch * cc:ch * cc + ch]
                acc += slab[prow + tw] @ bt.T
        hh = h0 + torch.arange(npx) // cols
        xx = x0 + torch.arange(npx) % cols
        cols_k = slice(nt * plan.bn, min((nt + 1) * plan.bn, kk))
        v = (acc[:npx, :cols_k.stop - cols_k.start] + bias[cols_k])
        out[b, dd, hh, xx, cols_k] = F.elu(v.to(x.dtype)).float()
    return out


@pytest.mark.parametrize("shape,k_out", [((1, 2, 6, 70, 16), 32),
                                         ((2, 3, 5, 9, 64), 64),
                                         ((1, 2, 3, 65, 128), 16),
                                         ((1, 1, 9, 33, 32), 128)], ids=str)
def test_kernel_tiling_emulated_matches_plain(shape, k_out):
    """The tile plan, the slab staging at -1 in D, H and W and the A-row
    mapping compute the conv: an fp32 emulation of the kernel's loop
    against the plain version."""
    x, w, b = _case(shape, k_out, seed=7)
    xt, kt, bt = _t(x), _kt(w, torch.float32), _t(b)
    got = _emulate_kernel(xt, kt, bt, k3.tile_plan(*shape, k_out))
    torch.testing.assert_close(got, k3.conv3d_k3_plain(xt, kt, bt), rtol=0,
                               atol=1e-4)


# --------------------------------------------------------------- routing


def _fake(mode, shape, dtype=torch.bfloat16, device="cuda", grad=False):
    t = mode.from_tensor(torch.zeros(shape, dtype=dtype, device="cpu")) \
        if device == "cpu" else torch.zeros(shape, dtype=dtype, device=device)
    return t.requires_grad_(grad)


ROUTES = {
    "bf16 3x3x3 stride 1": ({}, True),
    "C = K = 16": ({"c": 16, "k": 16}, True),
    "C = 128, K = 64": ({"c": 128, "k": 64}, True),
    "fp32": ({"dtype": torch.float32}, False),
    "cpu": ({"device": "cpu"}, False),
    "stride 2": ({"stride": 2}, False),
    "C = 8": ({"c": 8}, False),
    "K = 48": ({"k": 48}, False),
    "grad on x": ({"x_grad": True}, False),
    "grad on w": ({"w_grad": True}, False),
    "no kernel form": ({"kc": False}, False),
    "sharded": ({"sharded": True}, False),
    "4-D input": ({"dim": 4}, False),
}


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_routing_predicate(case, monkeypatch):
    """Which layer calls take the kernel: only CUDA bf16 5-D input to a
    3x3x3 stride-1 layer holding its kernel form, C and K in 16..128, no
    operand requiring grad, no `sharded_axis` in force."""
    opts, routes = ROUTES[case]
    c, k = opts.get("c", 32), opts.get("k", 32)
    dtype = opts.get("dtype", torch.bfloat16)
    with FakeTensorMode() as mode:
        # an (N, C, D, H, W) view of NDHWC memory, as the layers pass
        shape = (1, 4, 5, 6, c) if opts.get("dim", 5) == 5 else (1, 5, 6, c)
        x = _fake(mode, shape, dtype, opts.get("device", "cuda"))
        x = x.permute(0, x.dim() - 1, *range(1, x.dim() - 1)).requires_grad_(
            opts.get("x_grad", False))
        w = _fake(mode, (k, c, 3, 3, 3), torch.float32,
                  opts.get("device", "cuda"), opts.get("w_grad", False))
        kc = _fake(mode, (3, 3, 3, k, c)) if opts.get("kc", True) else None
        stride = opts.get("stride", 1)
        if opts.get("sharded"):
            monkeypatch.setattr(conv, "current_sharding", lambda: object())
        assert conv.conv3d_k3_routes(x, w, stride, kc) is routes
        if routes:  # the routed call reaches the op (its fake), no launch
            launches = k3.conv3d_k3.launches
            y = conv.conv3d_elu_ncdhw(x, w, _fake(mode, (k,), torch.float32),
                                      stride, kc)
            assert tuple(y.shape) == (1, k, 4, 5, 6)
            assert k3.conv3d_k3.launches == launches


def test_routing_under_sharded_axis(tmp_path):
    """A real `sharded_axis` (a one-rank gloo group) is in force: no
    kernel."""
    import torch.distributed as dist
    own = not dist.is_initialized()
    if own:
        dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                                rank=0, world_size=1)
    try:
        with FakeTensorMode() as mode:
            x = _fake(mode, (1, 32, 4, 5, 6))
            w = _fake(mode, (32, 32, 3, 3, 3), torch.float32)
            kc = _fake(mode, (3, 3, 3, 32, 32))
            assert conv.conv3d_k3_routes(x, w, 1, kc)
            with sharded_axis(dist.group.WORLD, -3, 4):
                assert not conv.conv3d_k3_routes(x, w, 1, kc)
    finally:
        if own:
            dist.destroy_process_group()


def test_sharded_forwards_reference_holds_no_kernel_form(tmp_path,
                                                        monkeypatch):
    """The unsharded reference of a sharded forward
    (`rank_checks.forward_cases`) drops the kernel forms of a bf16 net: a
    sharded forward never takes the kernel, so its reference computes the
    same arithmetic, and the net keeps its output on the CPU."""
    import torch.distributed as dist
    from redtail_tpu_torch.models import stereo
    from redtail_tpu_torch.parallel import rank_checks
    built = []
    make = stereo.params_from_numpy
    monkeypatch.setattr(stereo, "params_from_numpy",
                        lambda *a, **kw: built.append(make(*a, **kw))
                        or built[-1])
    spec = _small("nvtiny")
    params = init_stereo_params(spec, seed=1)
    rs = np.random.RandomState(4)
    left, right = (rs.rand(1, 16, 32, 3).astype(np.float32)
                   for _ in range(2))
    own = not dist.is_initialized()
    if own:
        dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                                rank=0, world_size=1)
    try:
        (res,) = rank_checks.forward_cases(0, 1, [dict(
            spec={"name": "nvtiny", "input_hw": (16, 32), "max_disp": 4},
            params=params, left=left, right=right, dtype="bfloat16",
            unsharded=True)], "cpu")
    finally:
        if own:
            dist.destroy_process_group()
    (net,) = built
    assert all(layer.kernel_kc is None for layer in net.encoder3D.values())
    held = make(spec, params, device="cpu", dtype=torch.bfloat16)
    assert any(layer.kernel_kc is not None
               for layer in held.encoder3D.values())
    with torch.no_grad():
        want = held(*(torch.from_numpy(f).bfloat16() for f in (left, right)))
    np.testing.assert_array_equal(res["disp"], want.float().numpy())


LAYERS = {
    "nvtiny": ("conv3D_2", "conv3D_4", "conv3D_5", "conv3D_7", "conv3D_8"),
    "nvsmall": ("conv3D_2", "conv3D_4", "conv3D_5", "conv3D_7", "conv3D_8"),
    "resnet18": ("conv3D_1b", "conv3D_2a", "conv3D_2b", "conv3D_3a",
                 "conv3D_3b", "conv3D_4a", "conv3D_4b", "conv3D_5a",
                 "conv3D_5b"),
}


def _small(name):
    return dataclasses.replace(STEREO_SPECS[name], input_hw=(16, 32),
                               max_disp=4)


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_kernel_form_held_at_load_by_the_stride1_layers(name):
    """A frozen bf16 net holds the kernel form of exactly the encoder
    loop's stride-1 layers; fp32 and trainable nets hold none."""
    spec = _small(name)
    params = init_stereo_params(spec, seed=0)
    net = params_from_numpy(spec, params, device="cpu", dtype=torch.bfloat16)
    held = {n for n, layer in net.encoder3D.items()
            if layer.kernel_kc is not None}
    assert held == set(LAYERS[name])
    for n in held:
        layer = net.encoder3D[n]
        assert torch.equal(k3.contract_weights(layer.kernel_kc).float(),
                           layer.weight)
    for kw in ({"dtype": torch.float32},
               {"dtype": torch.bfloat16, "trainable": True}):
        other = params_from_numpy(spec, params, device="cpu", **kw)
        assert all(layer.kernel_kc is None
                   for layer in other.encoder3D.values())


def test_routed_forward_is_bit_equal(monkeypatch):
    """With the kernel route forced on the CPU, where the op runs the plain
    version, a bf16 NVTiny forward calls the op once a stride-1 layer and
    gives today's output bit for bit."""
    spec = _small("nvtiny")
    net = params_from_numpy(spec, init_stereo_params(spec, seed=1),
                            device="cpu", dtype=torch.bfloat16)
    rs = np.random.RandomState(4)
    left, right = (torch.from_numpy(rs.rand(1, 16, 32, 3).astype(
        np.float32)).bfloat16() for _ in range(2))
    with torch.inference_mode():
        want = net(left, right)
    calls = []
    forward = k3._forward
    monkeypatch.setattr(conv, "conv3d_k3_routes",
                        lambda x, w, s, kc: kc is not None)
    monkeypatch.setattr(k3, "_forward",
                        lambda *a: calls.append(1) or forward(*a))
    with torch.inference_mode():
        got = net(left, right)
    assert len(calls) == len(LAYERS["nvtiny"])
    assert torch.equal(got, want)


# --------------------------------------------------------------- refusals


def test_wrapper_refuses_autograd_on_cuda():
    with FakeTensorMode() as mode:
        x = _fake(mode, (1, 2, 3, 4, 32), grad=True)
        kt, b = _fake(mode, (3, 3, 3, 32, 32)), _fake(mode, (32,),
                                                        torch.float32)
        with pytest.raises(RuntimeError, match="no backward"):
            k3.conv3d_k3(x, kt, b)
        with torch.no_grad():
            assert tuple(k3.conv3d_k3(x, kt, b).shape) == (1, 2, 3, 4, 32)


@pytest.mark.parametrize("bad", ["fp32", "strided", "channels", "device",
                                 "bias", "kernel"])
def test_wrapper_refuses_bad_cuda_input(bad):
    with FakeTensorMode() as mode:
        x = _fake(mode, (1, 2, 3, 4, 32))
        kt, b = _fake(mode, (3, 3, 3, 32, 32)), _fake(mode, (32,),
                                                        torch.float32)
        if bad == "fp32":
            x, kt = x.float(), kt.float()
        elif bad == "strided":   # an NCDHW-contiguous tensor viewed NDHWC
            x = _fake(mode, (1, 32, 2, 3, 4)).permute(0, 2, 3, 4, 1)
        elif bad == "channels":
            x, kt = _fake(mode, (1, 2, 3, 4, 8)), _fake(mode, (3, 3, 3, 32, 8))
        elif bad == "device":
            b = _fake(mode, (32,), torch.float32, device="cpu")
        elif bad == "bias":
            b = _fake(mode, (16,), torch.float32)
        else:
            kt = _fake(mode, (3, 3, 1, 32, 32))
        launches = k3.conv3d_k3.launches
        with pytest.raises((TypeError, ValueError)):
            k3.conv3d_k3(x, kt, b)
        assert k3.conv3d_k3.launches == launches
