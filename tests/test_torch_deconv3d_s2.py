"""The 3D decoder's transposed conv kernel (`redtail_tpu_torch/kernels/
deconv3d_s2.py`) on the CPU: its plain version against the JAX package's
`conv3d_transpose` + skip + `elu`, the (tap, class) table against the
shuffle decomposition's weights, the tiling and epilogue mapping the CUDA
kernel mirrors, the model's routing predicate, which layers hold the
kernel form, and the wrapper's refusals. The CUDA kernel is held against
the plain version on the card by `tests/test_torch_cuda.py` and
`chip_smoke.py`.

The routing and the refusals are checked on fake CUDA tensors
(`FakeTensorMode`: shapes, dtypes and devices, no data), which reach the
custom op's shape-only implementation and never a launch.
"""

import dataclasses
import itertools

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode

import jax.numpy as jnp

from redtail_tpu.ops.activations import elu as jelu
from redtail_tpu.ops.convolution import conv3d_transpose as jdeconv

import chip_smoke
from redtail_tpu_torch.kernels import _ops
from redtail_tpu_torch.kernels import conv223 as c223
from redtail_tpu_torch.kernels import deconv3d_s2 as d2
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


def _case(yshape, c_out, out_spatial, seed=0):
    """y (N, Dy, Hy, Wy, C), DHWIO w (3, 3, 3, c_out, C), bias and a skip
    (None where c_out = 1): outputs O(1), about half of them through the
    ELU's negative branch."""
    c = yshape[-1]
    skip = None if c_out == 1 else _rand(
        (yshape[0], *out_spatial, c_out), seed + 3, 0.5)
    return (_rand(yshape, seed), _rand((3, 3, 3, c_out, c), seed + 1,
                                       (8 * c) ** -0.5),
            _rand((c_out,), seed + 2, 0.3), skip)


def _layer_w(w):
    """DHWIO (3, 3, 3, c_out, C) -> the layer's (C, c_out, 3, 3, 3)."""
    return _t(w).permute(4, 3, 0, 1, 2).contiguous()


def _jax_ref(y, w, b, skip, out_spatial, dtype=jnp.float32):
    cast = lambda a: jnp.asarray(a, dtype)  # noqa: E731
    out = jdeconv(cast(y), cast(w), cast(b), out_spatial=out_spatial)
    if skip is not None:
        out = jelu(out + cast(skip))
    return np.asarray(out, np.float32)


def _run(y, w, b, skip, out_spatial, dtype=torch.float32):
    return d2.deconv3d_s2(
        _t(y).to(dtype), d2.kernel_weights(_layer_w(w), dtype),
        _t(b).to(dtype), None if skip is None else _t(skip).to(dtype),
        out_spatial)


def _bf16_steps(got, want):
    """|got - want| in bf16 steps of the larger magnitude, less the fp32
    summation-order allowance."""
    mag = np.maximum(np.abs(got), np.abs(want))
    step = 2.0 ** (np.floor(np.log2(np.maximum(mag, 2.0 ** -120))) - 7)
    return (np.abs(got - want) - ATOL) / step


# (y shape, c_out, out_spatial): each axis's output extent even (lo = 0)
# and odd (lo = 1), c_out = 1 and >= 16, C = 16..128, batch 2
PLAIN_CASES = [((2, 3, 4, 5, 16), 16, (6, 7, 9)),
               ((1, 2, 3, 6, 32), 32, (3, 6, 11)),
               ((2, 2, 3, 4, 64), 64, (4, 5, 8)),
               ((1, 2, 2, 3, 128), 32, (3, 4, 6)),
               ((2, 3, 4, 5, 32), 1, (5, 8, 10)),
               ((1, 2, 3, 4, 16), 1, (4, 5, 7))]


@pytest.mark.parametrize("yshape,c_out,out_spatial", PLAIN_CASES, ids=str)
def test_plain_matches_jax_fp32(yshape, c_out, out_spatial):
    y, w, b, skip = _case(yshape, c_out, out_spatial)
    want = _jax_ref(y, w, b, skip, out_spatial)
    got = _run(y, w, b, skip, out_spatial)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("yshape,c_out,out_spatial", PLAIN_CASES, ids=str)
def test_plain_matches_jax_bf16_within_a_step(yshape, c_out, out_spatial):
    """bf16 on both sides: the fp32 sum, the bias, one rounding, the skip
    add and the ELU in bf16; every element within one bf16 step (of the
    transposed conv, carried through the skip add and the ELU: each
    rounds once more, so two steps of the output at most)."""
    y, w, b, skip = _case(yshape, c_out, out_spatial, seed=3)
    want = _jax_ref(y, w, b, skip, out_spatial, jnp.bfloat16)
    got = _run(y, w, b, skip, out_spatial, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    steps = _bf16_steps(got.float().numpy(), want)
    assert (steps <= (1 if skip is None else 2)).all()
    assert (steps <= 0).mean() > 0.95
    if skip is not None:
        assert (want < 0).mean() > 0.2  # the ELU's negative branch


def test_plain_is_the_models_arithmetic():
    """The plain version is ``elu(conv3d_transpose_ncdhw(...) + skip)`` on
    fp32 carriers, bit for bit, and the kernel form round-trips."""
    y, w, b, skip = _case((1, 3, 4, 6, 32), 16, (5, 8, 11), seed=5)
    yb, sb = _t(y).bfloat16(), _t(skip).bfloat16()
    w_layer = _layer_w(w).bfloat16().float()       # the layer's carrier
    kt = d2.kernel_weights(w_layer)
    ncdhw = (0, 4, 1, 2, 3)
    want = F.elu(conv.conv3d_transpose_ncdhw(
        yb.permute(*ncdhw), w_layer, _t(b), out_spatial=(5, 8, 11))
        + sb.permute(*ncdhw)).permute(0, 2, 3, 4, 1)
    assert torch.equal(d2.deconv3d_s2(yb, kt, _t(b), sb, (5, 8, 11)), want)
    assert torch.equal(d2.contract_weights(kt).float(), w_layer)


def test_op_fake_and_flops():
    y, kt, b = torch.zeros(2, 3, 4, 5, 16), torch.zeros(27, 32, 16), \
        torch.zeros(32)
    skip = torch.zeros(2, 6, 7, 10, 32)
    with FakeTensorMode() as mode:
        out = torch.ops.redtail_torch.deconv3d_s2(
            mode.from_tensor(y), mode.from_tensor(kt), mode.from_tensor(b),
            mode.from_tensor(skip), [6, 7, 10])
    assert tuple(out.shape) == (2, 6, 7, 10, 32)
    assert _ops.deconv3d_s2_flops(y.shape, b.shape) == \
        2 * 27 * 16 * 32 * 120


# ------------------------------------------------------ the (tap, class) table


def test_pairs_cover_every_tap_once():
    """27 fed (offset, class) pairs, one per tap of the 3x3x3 kernel, in
    slot order; every class takes 1, 2, 4 or 8 of them."""
    pairs = d2.pairs()
    assert len(pairs) == 27
    assert sorted(d2.taps(*p) for p in pairs) == sorted(
        itertools.product(range(3), repeat=3))
    assert [d2.slot(*p) for p in pairs] == list(range(27))
    per_class = {}
    for off, cls in pairs:
        per_class.setdefault(cls, []).append(off)
    assert sorted(len(v) for v in per_class.values()) == \
        [1, 2, 2, 2, 4, 4, 4, 8]


@pytest.mark.parametrize("out_spatial", list(itertools.product((6, 7),
                                                               repeat=3)),
                         ids=str)
def test_pairs_are_the_shuffle_forms_nonzero_taps(out_spatial):
    """Against `ops/convolution.py:shuffle_weights` (the dense k = 2 form,
    parities r of the output, conv position a): class c of the kernel is
    parity c xor lo on each axis, and the shuffle form's entry (a, r) is
    the pair's weight where the offset feeds the class, zero elsewhere."""
    c_in, c_out = 3, 2
    w = torch.randn(3, 3, 3, c_out, c_in)
    k2 = conv.shuffle_weights(w, out_spatial)   # (2, 2, 2, c_in, 8 c_out)
    los = [conv.tf_same_padding(x, 3, 2)[0] for x in out_spatial]
    k2 = k2.reshape(2, 2, 2, c_in, 8, c_out)
    kt = d2.kernel_weights(w.permute(4, 3, 0, 1, 2), torch.float32)
    seen = 0
    for off in itertools.product((0, 1), repeat=3):
        for cls in itertools.product((0, 1), repeat=3):
            r = [c ^ lo for c, lo in zip(cls, los)]
            entry = k2[off + (slice(None), 4 * r[0] + 2 * r[1] + r[2])]
            if all(d2.fed(a, c) for a, c in zip(off, cls)):
                assert torch.equal(entry, kt[d2.slot(off, cls)].T)
                assert torch.equal(entry, w[d2.taps(off, cls)].T)
                seen += 1
            else:
                assert not entry.any()
    assert seen == 27


def test_shuffle_form_for_one_output_channel():
    """c_out = 1: (8 offsets, 8 classes, C), the pair's tap where the
    offset feeds the class, zero rows elsewhere; the inverse is exact."""
    w = torch.randn(5, 1, 3, 3, 3)
    kt = d2.kernel_weights(w, torch.float32)
    assert tuple(kt.shape) == (8, 8, 5)
    for o, off in enumerate(itertools.product((0, 1), repeat=3)):
        for k, cls in enumerate(itertools.product((0, 1), repeat=3)):
            if all(d2.fed(a, c) for a, c in zip(off, cls)):
                assert torch.equal(kt[o, k], w[(slice(None), 0)
                                               + d2.taps(off, cls)])
            else:
                assert not kt[o, k].any()
    assert torch.equal(d2.contract_weights(kt), w)


# ------------------------------------------------------------ the tiling

# The kernel's tiling of y (`tile_plan`, mirrored by `decode` and
# `launch_deconv` in csrc/): the served models' calls, then the tile edges
# (W = 33, 63, 64, 65, 70; H = 1), batch 2, every C and c_out.
PLAN_SHAPES = [(1, 12, 41, 129, 128, 64), (1, 24, 81, 257, 64, 32),
               (1, 48, 161, 513, 32, 1), (1, 5, 11, 33, 128, 64),
               (1, 17, 41, 129, 64, 64), (1, 34, 81, 257, 64, 32),
               (1, 68, 161, 513, 32, 1), (1, 24, 81, 257, 16, 1),
               (1, 12, 41, 129, 32, 16), (2, 2, 6, 63, 16, 32),
               (1, 1, 5, 64, 64, 16), (2, 2, 1, 70, 128, 1),
               (1, 3, 7, 65, 32, 64)]


def _tiles(plan):
    """(N tile, plane, h0, x0, rows, cols) of every tile, each N tile's
    blocks walking every tile of y."""
    for nt in range(plan.n_tiles):
        for t in range(plan.planes * plan.per_plane):
            plane, r = divmod(t, plan.per_plane)
            yield (nt, plane) + plan.tile(r)


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
def test_tile_plan_covers_each_position_once(shape):
    n, d, h, w, c, c_out = shape
    plan = d2.tile_plan(n, d, h, w, c, c_out)
    hits = np.zeros((plan.n_tiles, n * d, h, w), np.int32)
    staged = (plan.rows + 1) * (c223.TW + 1)
    for nt, plane, h0, x0, rows, cols in _tiles(plan):
        assert (rows + 1) * (cols + 1) <= staged and rows + 1 <= 256
        assert rows * cols <= plan.rows * c223.TW
        hits[nt, plane, h0:h0 + rows, x0:x0 + cols] += 1
    assert (hits == 1).all()
    bn = 8 if c_out == 1 else 16 if c_out == 16 or c == 128 else 32
    assert (plan.bn, plan.rows) == (bn, 8 if c_out == 1 else 2)
    assert plan.n_tiles == (1 if c_out == 1 else c_out // bn)
    assert plan.chunk == (32 if c <= 32 else 64)
    # the resident weights fit beside a ring of two slab stages
    slots = 8 if c_out == 1 else 27
    wbytes = plan.chunks * slots * bn * 2 * plan.chunk
    slab = -(-staged * 2 * plan.chunk // 1024) * 1024
    assert wbytes + 2 * slab <= 220 * 1024
    g = d2.grid(plan, 132)
    assert g % plan.n_tiles == 0 and g <= max(132, plan.n_tiles)


def test_shared_plans_are_unchanged():
    """conv223's and conv3d_k3's plans take no halo row and two halo
    columns, as before the halo was a parameter."""
    from redtail_tpu_torch.kernels import conv3d_k3 as k3
    plan = c223.tile_plan(1, 25, 82, 513, 128, 128)
    assert (plan.edge_rows, plan.edge_tiles, plan.halo_cols,
            plan.halo_rows) == (81, 1, 2, 0)
    plan = k3.tile_plan(1, 48, 161, 513, 32, 32)
    assert (plan.rows, plan.edge_rows, plan.edge_tiles) == (8, 161, 1)


def _emulate_kernel(y, kt, bias, skip, out_spatial):
    """The kernel's arithmetic in fp32 on the CPU, tile by tile, as
    `csrc/deconv3d_s2.cu` walks it: each K-step (chunk, ad) stages the
    slab of rows + 1 rows and cols + 1 columns from (x0 - 1, h0 - 1, d +
    ad - 1), zero outside the tensor and past C up to the chunk; A rows are
    read at slab pixel prow + ah (cols + 1) + aw; each fed (offset, class)
    pair's product lands in that class's accumulator (c_out = 1: one
    product an offset, the classes its 8 columns); then each class's
    output goes to voxel 2 m - lo + c, with the bias, the rounding to y's
    dtype and, with a skip, the skip add and the ELU."""
    n, d, h, w, c = y.shape
    c_out = bias.shape[0]
    plan = d2.tile_plan(n, d, h, w, c, c_out)
    ch, bn = plan.chunk, plan.bn
    los = [2 * a - x for a, x in zip((d, h, w), out_spatial)]
    yz = F.pad(y.float(), (0, ch * plan.chunks - c, 1, 1, 1,
                           max(plan.rows, plan.edge_rows) + 1, 1, 1))
    kz = F.pad(kt.float(), (0, ch * plan.chunks - c))
    out = torch.full((n, *out_spatial, c_out), float("nan"))
    classes = list(itertools.product((0, 1), repeat=3))
    for nt, plane, h0, x0, rows, cols in _tiles(plan):
        b, dd = divmod(plane, d)
        npx = min(rows, plan.hout - h0) * cols
        tile = plan.rows * c223.TW
        acc = torch.zeros((8, tile, bn))
        m = torch.arange(tile)
        m = torch.where(m < npx, m, torch.zeros_like(m))
        prow = (m // cols) * (cols + 1) + m % cols
        for cc in range(plan.chunks):
            chans = slice(ch * cc, ch * cc + ch)
            for ad in (0, 1):
                # padded index i is unpadded i - 1: the box at d + ad - 1
                slab = yz[b, dd + ad, h0:h0 + rows + 1, x0:x0 + cols + 1,
                          chans].reshape(-1, ch)
                for ah, aw in itertools.product((0, 1), repeat=2):
                    a = slab[prow + ah * (cols + 1) + aw]
                    off = (ad, ah, aw)
                    if c_out == 1:
                        acc[0] += a @ kz[4 * ad + 2 * ah + aw, :,
                                         chans].T
                        continue
                    for k, cls in enumerate(classes):
                        if all(d2.fed(o, q) for o, q in zip(off, cls)):
                            acc[k] += a @ kz[d2.slot(off, cls),
                                             nt * bn:(nt + 1) * bn, chans].T
        hh = h0 + torch.arange(npx) // cols
        xx = x0 + torch.arange(npx) % cols
        for k, cls in enumerate(classes):
            o = [2 * p - lo + q for p, lo, q in zip(
                (torch.full_like(hh, dd), hh, xx), los, cls)]
            live = (o[0] >= 0) & (o[1] >= 0) & (o[2] >= 0)
            if c_out == 1:
                v = (acc[0, :npx, k] + bias[0]).to(y.dtype)[live, None]
                cols_k = slice(0, 1)
            else:
                cols_k = slice(nt * bn, (nt + 1) * bn)
                v = (acc[k, :npx] + bias[cols_k]).to(y.dtype)[live]
            idx = (b, o[0][live], o[1][live], o[2][live], cols_k)
            if skip is not None:
                v = F.elu(v + skip[idx])
            out[idx] = v.float()
    return out


@pytest.mark.parametrize("yshape,c_out,out_spatial", [
    ((1, 2, 3, 70, 16), 32, (4, 5, 139)),
    ((2, 2, 5, 9, 64), 64, (3, 10, 17)),
    ((1, 2, 3, 65, 128), 16, (4, 6, 130)),
    ((1, 2, 4, 33, 32), 1, (3, 7, 65)),
    ((1, 1, 9, 66, 16), 1, (2, 18, 131)),
    ((1, 3, 2, 64, 64), 32, (5, 4, 127))], ids=str)
def test_kernel_tiling_emulated_matches_plain(yshape, c_out, out_spatial):
    """The tile plan, the slab staging at -1 in D, H and W, the A-row
    offsets, the (offset, class) products and the epilogue's mapping of
    classes to voxels compute the layer: an fp32 emulation of the kernel's
    loop against the plain version, every output written once."""
    y, w, b, skip = _case(yshape, c_out, out_spatial, seed=7)
    yt, kt, bt = _t(y), d2.kernel_weights(_layer_w(w), torch.float32), _t(b)
    st = None if skip is None else _t(skip)
    got = _emulate_kernel(yt, kt, bt, st, out_spatial)
    assert not got.isnan().any()
    torch.testing.assert_close(
        got, d2.deconv3d_s2_plain(yt, kt, bt, st, out_spatial), rtol=0,
        atol=1e-4)


# --------------------------------------------------------------- routing


def _fake(mode, shape, dtype=torch.bfloat16, device="cuda", grad=False):
    t = mode.from_tensor(torch.zeros(shape, dtype=dtype, device="cpu")) \
        if device == "cpu" else torch.zeros(shape, dtype=dtype, device=device)
    return t.requires_grad_(grad)


def _ncdhw_view(mode, shape, dtype=torch.bfloat16, device="cuda"):
    """An (N, C, D, H, W) view of NDHWC memory, as the layers pass."""
    t = _fake(mode, shape, dtype, device)
    return t.permute(0, t.dim() - 1, *range(1, t.dim() - 1))


ROUTES = {
    "bf16 3x3x3 stride 2 with a skip": ({}, True),
    "c_out = 1, no skip": ({"k": 1, "skip": False}, True),
    "C = 128, c_out = 64": ({"c": 128, "k": 64}, True),
    "C = 16, c_out = 16, odd and even extents": (
        {"c": 16, "k": 16, "out": (8, 9, 12)}, True),
    "fp32": ({"dtype": torch.float32}, False),
    "cpu": ({"device": "cpu"}, False),
    "stride 1": ({"stride": 1}, False),
    "C = 8": ({"c": 8}, False),
    "c_out = 48": ({"k": 48}, False),
    "grad on y": ({"y_grad": True}, False),
    "grad on w": ({"w_grad": True}, False),
    "no kernel form": ({"kt": False}, False),
    "sharded": ({"sharded": True}, False),
    "4-D input": ({"dim": 4}, False),
    "c_out = 32 without a skip": ({"skip": False}, False),
    "c_out = 1 with a skip": ({"k": 1}, False),
    "not ceil(out / 2)": ({"out": (6, 12, 12)}, False),
    "VALID": ({"padding": "VALID"}, False),
}


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_routing_predicate(case, monkeypatch):
    """Which decoder calls take the kernel: only CUDA bf16 5-D input to a
    3x3x3 stride-2 TF-SAME layer holding its kernel form, each input
    extent ceil(out / 2), C in 16..128, c_out in 1, 16, 32, 64, a skip
    exactly where c_out > 1, no operand requiring grad, no `sharded_axis`
    in force."""
    opts, routes = ROUTES[case]
    c, k = opts.get("c", 32), opts.get("k", 32)
    out = opts.get("out", (8, 10, 12))
    dtype, device = opts.get("dtype", torch.bfloat16), opts.get("device",
                                                              "cuda")
    with FakeTensorMode() as mode:
        if opts.get("dim", 5) == 5:
            y = _ncdhw_view(mode, (1, 4, 5, 6, c), dtype, device)
        else:
            y = _ncdhw_view(mode, (1, 5, 6, c), dtype, device)
        y.requires_grad_(opts.get("y_grad", False))
        w = _fake(mode, (c, k, 3, 3, 3), torch.float32, device,
                  opts.get("w_grad", False))
        kt = (_fake(mode, (8, 8, c) if k == 1 else (27, k, c))
              if opts.get("kt", True) else None)
        skip = (_ncdhw_view(mode, (1, *out, k), dtype, device)
                if opts.get("skip", True) else None)
        if opts.get("sharded"):
            monkeypatch.setattr(conv, "current_sharding", lambda: object())
        assert conv.deconv3d_s2_routes(
            y, w, skip, out, opts.get("stride", 2), kt,
            opts.get("padding", "SAME")) is routes
        if routes:  # the routed call reaches the op (its fake), no launch
            launches = d2.deconv3d_s2.launches
            got = conv.deconv3d_s2_ncdhw(
                y, w, _fake(mode, (k,), torch.float32), skip,
                out_spatial=out, kernel_s2=kt)
            assert tuple(got.shape) == (1, k, *out)
            assert d2.deconv3d_s2.launches == launches


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
            y = _ncdhw_view(mode, (1, 4, 5, 6, 32))
            w = _fake(mode, (32, 32, 3, 3, 3), torch.float32)
            kt = _fake(mode, (27, 32, 32))
            skip = _ncdhw_view(mode, (1, 8, 10, 12, 32))
            out = (8, 10, 12)
            assert conv.deconv3d_s2_routes(y, w, skip, out, 2, kt)
            with sharded_axis(dist.group.WORLD, -3, 4):
                assert not conv.deconv3d_s2_routes(y, w, skip, out, 2, kt)
    finally:
        if own:
            dist.destroy_process_group()


def _small(name):
    return dataclasses.replace(STEREO_SPECS[name], input_hw=(16, 32),
                               max_disp=4)


DECODERS = {"nvtiny": 3, "nvsmall": 3, "resnet18": 5}


@pytest.mark.parametrize("name", sorted(DECODERS) + ["resnet18_2d"])
def test_kernel_form_held_at_load_by_the_3d_decoder_layers(name):
    """A frozen bf16 net holds the kernel form of exactly its 3D decoder
    layers (none of ResNet18-2D's 2D bottleneck decoder); fp32 and
    trainable nets hold none."""
    spec = _small(name)
    params = init_stereo_params(spec, seed=0)
    net = params_from_numpy(spec, params, device="cpu", dtype=torch.bfloat16)
    held = {path for path, layer in net.named_modules()
            if getattr(layer, "kernel_s2", None) is not None}
    assert held == {f"decoder3D.{n}" for n, _, _ in spec.dec3d}
    assert len(held) == DECODERS.get(name, 0)
    for path in held:
        layer = net.get_submodule(path)
        assert torch.equal(d2.contract_weights(layer.kernel_s2).float(),
                           layer.weight)
    for kw in ({"dtype": torch.float32},
               {"dtype": torch.bfloat16, "trainable": True}):
        other = params_from_numpy(spec, params, device="cpu", **kw)
        assert all(getattr(layer, "kernel_s2", None) is None
                   for layer in other.modules())


def test_sharded_forwards_reference_holds_no_kernel_form(tmp_path,
                                                        monkeypatch):
    """The unsharded reference of a sharded forward
    (`rank_checks.forward_cases`) drops the transposed conv's kernel forms
    of a bf16 net as it drops the encoder's: a sharded forward never takes
    the kernel, so its reference computes the same arithmetic, and the
    net keeps its output on the CPU."""
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
    assert all(layer.kernel_s2 is None for layer in net.decoder3D.values())
    held = make(spec, params, device="cpu", dtype=torch.bfloat16)
    assert all(layer.kernel_s2 is not None
               for layer in held.decoder3D.values())
    with torch.no_grad():
        want = held(*(torch.from_numpy(f).bfloat16() for f in (left, right)))
    np.testing.assert_array_equal(res["disp"], want.float().numpy())


@pytest.mark.parametrize("name", sorted(DECODERS))
def test_routed_forward_is_bit_equal(name, monkeypatch):
    """With the kernel route forced on the CPU, where the op runs the plain
    version, a bf16 forward calls the op once a decoder layer (the last
    without a skip) and gives today's output bit for bit."""
    spec = _small(name)
    net = params_from_numpy(spec, init_stereo_params(spec, seed=1),
                            device="cpu", dtype=torch.bfloat16)
    rs = np.random.RandomState(4)
    left, right = (torch.from_numpy(rs.rand(1, 16, 32, 3).astype(
        np.float32)).bfloat16() for _ in range(2))
    with torch.inference_mode():
        want = net(left, right)
    calls = []
    forward = d2._forward
    monkeypatch.setattr(conv, "deconv3d_s2_routes",
                        lambda y, w, skip, o, s, kt: kt is not None)
    monkeypatch.setattr(d2, "_forward", lambda *a: calls.append(
        a[3] is None) or forward(*a))
    with torch.inference_mode():
        got = net(left, right)
    assert calls == [False] * (DECODERS[name] - 1) + [True]
    assert torch.equal(got, want)


def test_packed_head_and_plain_lowering_routes():
    """The packed head's decoder is its own (`_PackedConv3d`, dfold): a
    bf16 NVTiny forward under `packed3d_lowering()` with the D-folded
    final deconv calls the op never; the plain lowering runs the same
    decoder loop as the fused head."""
    import os
    spec = _small("nvtiny")
    net = params_from_numpy(spec, init_stereo_params(spec, seed=1),
                            device="cpu", dtype=torch.bfloat16)
    rs = np.random.RandomState(4)
    left, right = (torch.from_numpy(rs.rand(1, 16, 32, 3).astype(
        np.float32)).bfloat16() for _ in range(2))
    calls = []
    forward = d2._forward
    saved = (conv.deconv3d_s2_routes, d2._forward,
             os.environ.get("REDTAIL_TPU_DFOLD"))
    try:
        conv.deconv3d_s2_routes = lambda y, w, skip, o, s, kt: \
            kt is not None
        d2._forward = lambda *a: calls.append(1) or forward(*a)
        os.environ["REDTAIL_TPU_DFOLD"] = "1"
        with torch.inference_mode(), conv.packed3d_lowering():
            net(left, right)
        assert calls == []
        with torch.inference_mode(), conv.plain_lowering():
            net(left, right)
        assert len(calls) == DECODERS["nvtiny"]
    finally:
        conv.deconv3d_s2_routes, d2._forward = saved[:2]
        if saved[2] is None:
            os.environ.pop("REDTAIL_TPU_DFOLD", None)
        else:
            os.environ["REDTAIL_TPU_DFOLD"] = saved[2]


# --------------------------------------------------------------- refusals


def _fake_call(mode, bad=None):
    y = _fake(mode, (1, 2, 3, 4, 32))
    kt, b = _fake(mode, (27, 32, 32)), _fake(mode, (32,), torch.float32)
    skip, out = _fake(mode, (1, 4, 6, 8, 32)), [4, 6, 8]
    if bad == "fp32":
        y, kt, skip = y.float(), kt.float(), skip.float()
    elif bad == "strided":   # an NCDHW-contiguous tensor viewed NDHWC
        y = _fake(mode, (1, 32, 2, 3, 4)).permute(0, 2, 3, 4, 1)
    elif bad == "channels":
        y, kt = _fake(mode, (1, 2, 3, 4, 8)), _fake(mode, (27, 32, 8))
    elif bad == "device":
        b = _fake(mode, (32,), torch.float32, device="cpu")
    elif bad == "bias":
        b = _fake(mode, (16,), torch.float32)
    elif bad == "kernel":
        kt = _fake(mode, (8, 32, 32))
    elif bad == "out_spatial":
        out = [4, 6, 9]
    elif bad == "no skip":
        skip = None
    elif bad == "skip shape":
        skip = _fake(mode, (1, 4, 6, 7, 32))
    return y, kt, b, skip, out


def test_wrapper_refuses_autograd_on_cuda():
    with FakeTensorMode() as mode:
        y, kt, b, skip, out = _fake_call(mode)
        y.requires_grad_(True)
        with pytest.raises(RuntimeError, match="no backward"):
            d2.deconv3d_s2(y, kt, b, skip, out)
        with torch.no_grad():
            assert tuple(d2.deconv3d_s2(y, kt, b, skip, out).shape) == \
                (1, 4, 6, 8, 32)


@pytest.mark.parametrize("bad", ["fp32", "strided", "channels", "device",
                                 "bias", "kernel", "out_spatial", "no skip",
                                 "skip shape"])
def test_wrapper_refuses_bad_cuda_input(bad):
    with FakeTensorMode() as mode:
        args = _fake_call(mode, bad)
        launches = d2.deconv3d_s2.launches
        with pytest.raises((TypeError, ValueError)):
            d2.deconv3d_s2(*args)
        assert d2.deconv3d_s2.launches == launches


def test_chip_smoke_cases_are_the_model_calls():
    """`chip_smoke.D2_CASES` opens with every decoder call of the three
    served 3D models at 321x1025 (NVTiny at its 161x513), in order."""
    from redtail_tpu_torch.models.stereo import _half
    calls = []
    for name, hw in (("nvsmall", (321, 1025)), ("resnet18", (321, 1025)),
                     ("nvtiny", (161, 513))):
        spec = STEREO_SPECS[name]
        ext, skips = (spec.max_disp, *_half(hw)), {}
        for layer in spec.enc3d[1:]:
            if layer.stride == 2:
                ext = tuple(-(-v // 2) for v in ext)
            skips[layer.name] = ext
        y, c = ext, spec.enc3d[-1].out_ch
        for _, c_out, skip in spec.dec3d:
            out = skips[skip] if skip else (spec.full_max_disp, *hw)
            calls.append(((1, *y, c), c_out, out))
            y, c = out, c_out
    got = [(yshape, c_out, out) for _, yshape, c_out, out
           in chip_smoke.D2_CASES[:len(calls)]]
    assert got == calls
