"""The conv223 kernel's plain version (`redtail_tpu_torch/kernels/conv223.py`)
and the port's in-shifted, H-packed `conv3d_packed`, which calls it, against
the TPU kernel it replaces, `conv223_pallas` (interpret mode on the CPU), and
the wrapper's rules, on the CPU. The CUDA kernel is held against the plain
version on the card by `tests/test_torch_cuda.py` and `chip_smoke.py`.

Inputs are seeded numpy; biases random and nonzero. fp32 on both sides
(the Pallas kernel at HIGHEST): summation order only, 1e-5.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp
from jax import lax

from redtail_tpu.kernels.conv223_pallas import conv223_pallas
from redtail_tpu.ops import packed3d as J

from redtail_tpu_torch.kernels import conv223 as c223
from redtail_tpu_torch.ops import packed3d as P

ATOL = 1e-5  # fp32 on both sides, summation order only


def _rand(shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _packed_case(dhw, c, k_out, n=1):
    """A shifted DH-packed input of an (n, *dhw, c) volume, the band
    kernel (2, 2, 3, 4c, 4k) and a group-tiled bias, as `conv3d_packed`
    hands them to the kernel."""
    x = _rand((n, *dhw, c))
    w = _rand((3, 3, 3, c, k_out), 1, 0.2)
    b = _rand((k_out,), 2)
    xp = np.asarray(J.pack(jnp.asarray(x), d=True, h=True, shifted=True))
    k = np.asarray(J._kernel(jnp.asarray(w), J._A(
        lambda s, q, r: 2 * s + q - r, 2, 2, 2), J._A(
        lambda s, q, r: 2 * s + q - r, 2, 2, 2), J._A_ID))
    return x, w, b, xp, k, np.tile(b, 4)


# tests/test_packed3d.py:405's shapes; H_out = 9, so the Pallas row block
# bh = 3 divides it
@pytest.mark.parametrize("dhw", [(8, 17, 12), (7, 18, 16)], ids=str)
def test_plain_matches_pallas_kernel(dhw):
    _, _, _, xp, k, bt = _packed_case(dhw, 4, 4)
    assert (xp.shape[2] - 1) % 3 == 0
    want = np.asarray(conv223_pallas(jnp.asarray(xp), jnp.asarray(k),
                                     jnp.asarray(bt), bh=3, interpret=True))
    got = c223.conv223(_t(xp), _t(k), _t(bt))
    assert got.shape == want.shape == (1, xp.shape[1] - 1, xp.shape[2] - 1,
                                       dhw[2], 16)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("dhw", [(8, 17, 12), (7, 18, 16)], ids=str)
def test_conv3d_packed_matches_pallas_path(monkeypatch, dhw):
    """The port's in-shifted, H-packed `conv3d_packed` (through the
    kernel's plain version here) against the JAX op on its Mosaic path
    (`REDTAIL_TPU_PALLAS_CONV3D=1`, interpret mode off the TPU): bias,
    boundary masks and parities included."""
    x, w, b, xp, _, _ = _packed_case(dhw, 4, 4)
    monkeypatch.setenv("REDTAIL_TPU_PALLAS_CONV3D", "1")
    assert J._pallas_bh(xp, np.zeros((2, 2, 3, 16, 16))) is not None, \
        "the JAX op must take the Mosaic path (else the test is vacuous)"
    want = np.asarray(J.conv3d_packed(jnp.asarray(xp), w, b,
                                      full_spatial=dhw))
    before = c223.conv223.launches
    got = P.conv3d_packed(_t(xp), _t(w), _t(b), full_spatial=dhw)
    assert c223.conv223.launches == before   # the CPU took the plain version
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("xshape,k_out", [
    ((2, 4, 6, 20, 32), 32),     # batch 2
    ((1, 5, 7, 9, 16), 16),      # odd Dp and Hp, C = K = 16
    ((1, 3, 4, 5, 16), 48),      # W < 8, K != C
], ids=str)
def test_plain_matches_xla_dense_conv(xshape, k_out):
    """The plain version is the dense (2, 2, 3) conv with W padded (1, 1)
    and the bias: `lax.conv_general_dilated` at HIGHEST."""
    xp = _rand(xshape, 3)
    k = _rand((2, 2, 3, xshape[-1], k_out), 4, 0.2)
    b = _rand((k_out,), 5)
    want = np.asarray(lax.conv_general_dilated(
        jnp.asarray(xp), jnp.asarray(k), (1, 1, 1), [(0, 0), (0, 0), (1, 1)],
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC"),
        precision=lax.Precision.HIGHEST)) + b
    np.testing.assert_allclose(c223.conv223(_t(xp), _t(k), _t(b)).numpy(),
                               want, atol=ATOL)


def test_plain_bf16_rounds_once():
    """bf16 in and out: the fp32 sum of the bf16 products, rounded once."""
    xp = _t(_rand((1, 3, 4, 10, 16), 6)).bfloat16()
    k = _t(_rand((2, 2, 3, 16, 16), 7, 0.2)).bfloat16()
    b = _t(_rand((16,), 8))
    got = c223.conv223_plain(xp, k, b)
    assert got.dtype == torch.bfloat16
    want = c223.conv223_plain(xp.float(), k.float(), b).bfloat16()
    assert torch.equal(got, want)


def test_cpu_takes_plain_version_without_counting():
    xp, k, b = (_t(_rand(s, i)) for i, s in enumerate(
        ((1, 3, 4, 6, 16), (2, 2, 3, 16, 16), (16,))))
    before = c223.conv223.launches
    got = c223.conv223(xp, k, b)
    assert c223.conv223.launches == before
    torch.testing.assert_close(got, c223.conv223_plain(xp, k, b), rtol=0,
                               atol=0)
    no_bias = c223.conv223(xp, k, None)
    torch.testing.assert_close(no_bias + b, got, rtol=0, atol=1e-6)


@pytest.mark.parametrize("bad", ["rank", "taps", "channels", "dtype",
                                 "mixed_dtype", "bias", "empty", "device"])
def test_wrapper_rejects_bad_input(bad):
    xp = _t(_rand((1, 3, 4, 6, 16)))
    k = _t(_rand((2, 2, 3, 16, 16), 1))
    b = torch.zeros(16)
    if bad == "rank":
        xp = xp[0]
    elif bad == "taps":
        k = _t(_rand((3, 3, 3, 16, 16), 1))
    elif bad == "channels":
        k = k[:, :, :, :8]
    elif bad == "dtype":
        xp, k = xp.half(), k.half()
    elif bad == "mixed_dtype":
        k = k.bfloat16()
    elif bad == "bias":
        b = torch.zeros(8)
    elif bad == "empty":
        xp = xp[:, :1]
    elif bad == "device":
        k = k.to("meta")
    with pytest.raises((TypeError, ValueError)):
        c223.conv223(xp, k, b)


# The bf16 kernel's tiling (`tile_plan`, mirrored by `decode` in
# csrc/conv223.cu): shapes of the three models' calls, the tile edges
# (W = 63, 64, 65, Hout not a multiple of 4), W < 64, K > 128, batch 2.
PLAN_SHAPES = [(1, 25, 82, 513, 128, 128), (1, 35, 82, 513, 128, 128),
               (1, 13, 42, 257, 64, 64), (1, 3, 6, 63, 32, 16),
               (1, 3, 6, 64, 64, 32), (1, 3, 6, 65, 16, 64),
               (2, 3, 9, 130, 64, 128), (1, 2, 3, 65, 64, 144),
               (1, 3, 4, 5, 16, 16), (2, 4, 6, 20, 32, 32)]


def _tiles(plan):
    """Every tile of the plan as (N tile, plane, h0, x0, rows, cols), in
    the kernel's order."""
    for t in range(plan.tiles):
        nt, r = divmod(t, plan.planes * plan.per_plane)
        plane, r = divmod(r, plan.per_plane)
        yield (nt, plane) + plan.tile(r)


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
def test_tile_plan_covers_each_output_once(shape):
    n, dp, hp, w, c, k = shape
    plan = c223.tile_plan(n, dp, hp, w, c, k)
    hits = np.zeros((plan.n_tiles, n * (dp - 1), hp - 1, w), np.int32)
    for nt, plane, h0, x0, rows, cols in _tiles(plan):
        # the staged slab and the outputs fit one ring stage's room
        assert rows * (cols + 2) <= c223.SLAB_PIXELS
        assert rows * cols <= c223.TILE_PIXELS and rows <= 256
        hits[nt, plane, h0:h0 + rows, x0:x0 + cols] += 1
    assert (hits == 1).all()
    assert plan.bn in (64, 128) and plan.n_tiles * plan.bn >= k
    assert plan.steps == 4 * -(-c // 64)


def test_tile_plan_ragged_w_costs_no_full_tile():
    """At W = 513 the last column is one edge tile per plane: the m64
    blocks that run cover the outputs within 5% (a 64-column tile per row
    pair would cost 1/9 more)."""
    plan = c223.tile_plan(1, 25, 82, 513, 128, 128)
    assert (plan.rem, plan.edge_rows, plan.edge_tiles) == (1, 81, 1)
    outputs = 24 * 81 * 513
    blocks = sum(-(-min(rows, plan.hout - h0) * cols // 64)
                 for _, _, h0, _, rows, cols in _tiles(plan))
    assert outputs <= 64 * blocks <= 1.05 * outputs


def _emulate_bf16_kernel(xp, k, bias, plan):
    """The bf16 kernel's arithmetic in fp32 on the CPU, tile by tile: each
    K-step's slab as TMA stages it (zero outside the tensor), A rows read
    at the tap's pixel offset, B from the K-major weights."""
    n, dp, hp, w, c = xp.shape
    kt = c223.kernel_weights(k)              # (2, 2, 3, K, C)
    kk = kt.shape[3]
    # zero fill past every edge TMA can reach: x = -1 and W, rows past Hp,
    # channels past C up to the 64-channel chunk
    xz = F.pad(xp.float(), (0, 64 * plan.chunks - c, 1, 1, 0, c223.TH))
    kz = F.pad(kt.float(), (0, 64 * plan.chunks - c, 0,
                            plan.n_tiles * plan.bn - kk))
    out = torch.full((n, dp - 1, hp - 1, w, kk), float("nan"))
    for nt, plane, h0, x0, rows, cols in _tiles(plan):
        b, d = divmod(plane, dp - 1)
        npx = min(rows, plan.hout - h0) * cols
        acc = torch.zeros((c223.TILE_PIXELS, plan.bn))
        m = torch.arange(c223.TILE_PIXELS)
        m = torch.where(m < npx, m, torch.zeros_like(m))
        prow = (m // cols) * (cols + 2) + m % cols
        for st in range(plan.steps):
            cc, td, th = st >> 2, (st >> 1) & 1, st & 1
            # the slab: rows x (cols + 2) pixels from (x0 - 1, h0 + th)
            slab = xz[b, d + td, h0 + th:h0 + th + rows,
                      x0:x0 + cols + 2, 64 * cc:64 * cc + 64]
            slab = slab.reshape(-1, 64)
            for tw in range(3):
                bt = kz[td, th, tw, nt * plan.bn:(nt + 1) * plan.bn,
                        64 * cc:64 * cc + 64]
                acc += slab[prow + tw] @ bt.T
        hh = h0 + torch.arange(npx) // cols
        xx = x0 + torch.arange(npx) % cols
        cols_k = slice(nt * plan.bn, min((nt + 1) * plan.bn, kk))
        out[b, d, hh, xx, cols_k] = (acc[:npx, :cols_k.stop - cols_k.start]
                                     + bias[cols_k])
    return out


@pytest.mark.parametrize("shape", [(1, 3, 6, 130, 64, 64),
                                   (2, 3, 7, 65, 48, 32),
                                   (1, 2, 3, 65, 64, 144),
                                   (1, 3, 4, 5, 16, 16),
                                   (1, 2, 5, 70, 128, 128)], ids=str)
def test_bf16_kernel_tiling_emulated_matches_plain(shape):
    """The tile plan, the slab staging and the A-row mapping compute the
    conv: an fp32 emulation of the kernel's loop against the plain
    version."""
    n, dp, hp, w, c, kk = shape
    xp = _t(_rand((n, dp, hp, w, c), 9))
    k = _t(_rand((2, 2, 3, c, kk), 10, 0.2))
    b = _t(_rand((kk,), 11))
    got = _emulate_bf16_kernel(xp, k, b, c223.tile_plan(n, dp, hp, w, c, kk))
    torch.testing.assert_close(got, c223.conv223_plain(xp, k, b), rtol=0,
                               atol=1e-4)


def test_kernel_weights_round_trip():
    k = _t(_rand((2, 2, 3, 48, 32), 12))
    kt = c223.kernel_weights(k)
    assert kt.shape == (2, 2, 3, 32, 48) and kt.is_contiguous()
    assert torch.equal(kt[1, 0, 2, 5, 7], k[1, 0, 2, 7, 5])
    assert torch.equal(c223.contract_weights(kt), k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_takes_kernel_form_weights(dtype):
    """``k_layout="kc"`` (the packed head's stored form) gives the same
    result as the (2, 2, 3, C, K) form on the CPU, counting no launch."""
    xp = _t(_rand((1, 3, 4, 9, 16), 13)).to(dtype)
    k = _t(_rand((2, 2, 3, 16, 32), 14, 0.2)).to(dtype)
    b = _t(_rand((32,), 15))
    before = c223.conv223.launches
    got = c223.conv223(xp, c223.kernel_weights(k), b, "kc")
    assert c223.conv223.launches == before
    assert torch.equal(got, c223.conv223(xp, k, b))
    with pytest.raises(ValueError):
        c223.conv223(xp, k, b, "kc")         # (.., C, K) given as "kc"
    with pytest.raises(ValueError):
        c223.conv223(xp, k, b, "oi")


def test_packed_prepare_stores_the_kernel_form():
    """`prepare(k, "conv223")` is the K-major form, and `conv3d_packed`
    takes it as the model holds it."""
    x, w, b, xp, k, _ = _packed_case((7, 18, 16), 4, 4)
    kt = P.prepare(_t(k), "conv223")
    assert torch.equal(c223.contract_weights(kt), _t(k))
    got = P.conv3d_packed(_t(xp), None, _t(b), full_spatial=(7, 18, 16),
                          kernel=kt)
    want = P.conv3d_packed(_t(xp), _t(w), _t(b), full_spatial=(7, 18, 16))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
