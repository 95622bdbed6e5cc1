"""The port's correlation cost volume against the JAX package's, on the CPU.

On the CPU the wrapper runs the kernel's plain PyTorch version; it is held
against the JAX XLA volume (`corr_cost_volume_dlast`), against the Pallas
kernel it replaces (`corr_cost_volume_pallas`, in interpret mode as
`tests/test_kernels.py` runs it) and against the in-repo golden fixture.
The CUDA kernel itself is held against the plain version on the card, at
the same shapes, by `tests/test_torch_cuda.py` and `chip_smoke.py`.
"""

import numpy as np
import pytest
import torch

from redtail_tpu.kernels import corr_cost_volume_pallas
from redtail_tpu.ops.cost_volume import corr_cost_volume_dlast as jdlast

from conftest import LOCAL_GOLDEN_DIR
from redtail_tpu_torch.io import read_bin
from redtail_tpu_torch.kernels import corr_cost_volume as corr
from redtail_tpu_torch.ops import corr_cost_volume_dlast
from test_torch_cuda import SHAPES


def _pair(shape, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(*shape).astype(np.float32),
            rs.randn(*shape).astype(np.float32))


@pytest.mark.parametrize("shape,d", [s for s in SHAPES if s[1] <= s[0][2]])
def test_plain_matches_xla_dlast(shape, d):
    """(The XLA slices form needs D <= W; the D > W case is the Pallas
    test's.)"""
    left, right = _pair(shape)
    got = corr_cost_volume_dlast(torch.from_numpy(left),
                                 torch.from_numpy(right), d)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape[:3] + (d,)
    # fp32 products summed over C in another order
    np.testing.assert_allclose(got.numpy(), np.asarray(jdlast(left, right, d)),
                               atol=1e-5)


@pytest.mark.parametrize("shape,d", SHAPES)
def test_plain_matches_pallas_kernel(shape, d):
    left, right = _pair(shape, seed=1)
    want = np.asarray(corr_cost_volume_pallas(left, right, d))  # (N,H,D,W)
    got = corr.corr_cost_volume(torch.from_numpy(left),
                                torch.from_numpy(right), d, layout="hdw")
    assert tuple(got.shape) == want.shape
    # the Pallas kernel also sums fp32 products; only the order differs
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_plain_bf16_matches_pallas_kernel():
    import jax.numpy as jnp

    left, right = _pair((2, 14, 33, 8), seed=2)
    want = np.asarray(corr_cost_volume_pallas(
        jnp.asarray(left, jnp.bfloat16), jnp.asarray(right, jnp.bfloat16),
        6)).astype(np.float32)
    got = corr.corr_cost_volume(torch.from_numpy(left).bfloat16(),
                                torch.from_numpy(right).bfloat16(), 6,
                                layout="hdw")
    assert got.dtype == torch.bfloat16
    # one fp32 sum rounded to bf16 on each side: equal up to one bf16 ulp
    # where the two fp32 sums straddle a rounding boundary
    diff = np.abs(got.float().numpy() - want)
    mag = np.maximum(np.abs(want), 2.0 ** -126)
    assert (diff <= 2.0 ** (np.floor(np.log2(mag)) - 7) + 1e-5).all()


def test_plain_matches_golden_fixture():
    def nhwc(a):
        return torch.from_numpy(np.transpose(a, (0, 2, 3, 1)))

    left = nhwc(read_bin(LOCAL_GOLDEN_DIR / "corr_cost_vol_01_l.bin"))
    right = nhwc(read_bin(LOCAL_GOLDEN_DIR / "corr_cost_vol_01_r.bin"))
    want = read_bin(LOCAL_GOLDEN_DIR / "corr_cost_vol_01_cv.bin")  # NDCHW
    got = corr_cost_volume_dlast(left, right, 2)  # (N, H, W, D)
    # same gate as tests/test_ops_golden.py::test_corr_cost_volume_golden
    np.testing.assert_allclose(
        got.permute(0, 3, 1, 2).unsqueeze(2).numpy(), want, atol=1e-5)


def test_cpu_takes_plain_version_without_counting():
    left, right = (torch.from_numpy(a) for a in _pair((1, 2, 9, 3)))
    before = corr.corr_cost_volume.launches
    got = corr.corr_cost_volume(left, right, 4)
    assert corr.corr_cost_volume.launches == before
    torch.testing.assert_close(
        got, corr.corr_cost_volume_plain(left, right, 4), rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["dtype", "mixed_dtype", "shape", "rank",
                                 "max_disp", "layout", "empty", "device"])
def test_wrapper_rejects_bad_input(bad):
    left, right = (torch.from_numpy(a) for a in _pair((1, 2, 9, 3)))
    d, layout = 4, "dlast"
    if bad == "dtype":
        left, right = left.half(), right.half()
    elif bad == "mixed_dtype":
        right = right.bfloat16()
    elif bad == "shape":
        right = right[:, :, :8]
    elif bad == "rank":
        left, right = left[0], right[0]
    elif bad == "max_disp":
        d = 0
    elif bad == "layout":
        layout = "ndhw"
    elif bad == "empty":
        left, right = left[:, :0], right[:, :0]
    elif bad == "device":
        right = right.to("meta")
    with pytest.raises((TypeError, ValueError)):
        corr.corr_cost_volume(left, right, d, layout=layout)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    from redtail_tpu_torch.kernels import _build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


# ---------------------------------------------------------------- the fused
# soft-argmax epilogue (`corr_softargmax`): on the CPU the wrapper runs its
# plain version, the `dlast` volume then `ops/softargmax.py`.

def _scaled_pair(shape, dtype, seed):
    """Inputs scaled by 1/sqrt(C), so the volume is O(1) as trained features
    make it (the soft-argmax turns the summation-order noise of a ~1e1
    volume into more than 1e-5). bf16: the port takes the bf16 values, JAX
    the same values in fp32 (products of bf16 values are exact in fp32, so
    only the summation order differs)."""
    left, right = (a / np.sqrt(shape[-1]) for a in _pair(shape, seed))
    tl, tr = torch.from_numpy(left).to(dtype), torch.from_numpy(right).to(dtype)
    return tl, tr, tl.float().numpy(), tr.float().numpy()


DTYPE_IDS = {torch.float32: "fp32", torch.bfloat16: "bf16"}


@pytest.mark.parametrize("dtype", DTYPE_IDS, ids=DTYPE_IDS.get)
@pytest.mark.parametrize("shape,d", [s for s in SHAPES if s[1] <= s[0][2]])
def test_softargmax_matches_xla(shape, d, dtype):
    from redtail_tpu.ops.softargmax import softargmax as jsoftargmax

    tl, tr, left, right = _scaled_pair(shape, dtype, seed=3)
    got = corr.corr_softargmax(tl, tr, d)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape[:3]
    want = np.asarray(jsoftargmax(jdlast(left, right, d), axis=-1))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("dtype", DTYPE_IDS, ids=DTYPE_IDS.get)
@pytest.mark.parametrize("shape,d", SHAPES)
def test_softargmax_matches_pallas_kernel(shape, d, dtype):
    """D > W included: the masked zeros (x < d) take part in the softmax
    as the zeros the Pallas kernel writes."""
    from redtail_tpu.ops.softargmax import softargmax as jsoftargmax

    tl, tr, left, right = _scaled_pair(shape, dtype, seed=4)
    want = np.asarray(jsoftargmax(corr_cost_volume_pallas(left, right, d),
                                  axis=2))
    got = corr.corr_softargmax(tl, tr, d)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_softargmax_cpu_is_the_composition_without_counting():
    """The model's CPU path is unchanged bit for bit: the volume, then the
    soft-argmax op; neither counter moves."""
    from redtail_tpu_torch.ops import corr_softargmax_dlast, softargmax

    left, right = (torch.from_numpy(a) for a in _pair((1, 3, 11, 5)))
    before = (corr.corr_cost_volume.launches, corr.corr_softargmax.launches)
    got = corr_softargmax_dlast(left, right, 7)
    want = softargmax(corr_cost_volume_dlast(left, right, 7), axis=-1)
    assert (corr.corr_cost_volume.launches,
            corr.corr_softargmax.launches) == before
    assert torch.equal(got, want)


@pytest.mark.parametrize("bad", ["dtype", "mixed_dtype", "shape", "rank",
                                 "max_disp", "empty", "device"])
def test_softargmax_wrapper_rejects_bad_input(bad):
    left, right = (torch.from_numpy(a) for a in _pair((1, 2, 9, 3)))
    d = 4
    if bad == "dtype":
        left, right = left.half(), right.half()
    elif bad == "mixed_dtype":
        right = right.bfloat16()
    elif bad == "shape":
        right = right[:, :, :8]
    elif bad == "rank":
        left, right = left[0], right[0]
    elif bad == "max_disp":
        d = 2.5
    elif bad == "empty":
        left, right = left[:, :0], right[:, :0]
    elif bad == "device":
        right = right.to("meta")
    before = corr.corr_softargmax.launches
    with pytest.raises((TypeError, ValueError)):
        corr.corr_softargmax(left, right, d)
    assert corr.corr_softargmax.launches == before


# ---------------------------------------------------------------- the
# kernel's tiling (`tile_plan`, mirrored by `csrc/corr_cost_volume.cu`),
# emulated lane by lane.

def _fragment(nt):
    """The m16n8 accumulator layout of `mma.sync` (and of the fp32 path):
    (lane, j, r) -> (row, column) of the warp's 16 x (8 nt) tile."""
    lane, j, r = np.meshgrid(np.arange(32), np.arange(nt), np.arange(4),
                             indexing="ij")
    g, t = lane // 4, lane % 4
    return (lane.ravel(), j.ravel(), (g + 8 * (r // 2)).ravel(),
            (8 * j + 2 * t + r % 2).ravel())


@pytest.mark.parametrize("d", [48, 49, 9, 1, 130])
@pytest.mark.parametrize("w", [513, 65, 64, 37, 5])
def test_tile_plan_covers_each_output_once(w, d):
    plan = corr.tile_plan(w, 32, d, torch.bfloat16)
    hits = np.zeros((plan.x_groups * corr.WX, d), np.int32)
    for i in range(plan.d_chunks):
        d0, dc, nt = plan.chunk(i)
        assert 1 <= dc <= corr.DC and nt <= plan.nt_max
        _, _, row, col = _fragment(nt)
        # the tile's (row, column) pairs are each held once
        assert len(set(zip(row, col))) == len(row) == 16 * 8 * nt
        for xg in range(plan.x_groups):
            x0 = xg * corr.WX
            x, y = x0 + row, plan.y_start(x0, i) + col
            dd = x - y
            band = (dd >= d0) & (dd < d0 + dc)
            assert ((dd[band] >= 0) & (dd[band] < d)).all()
            np.add.at(hits, (x[band], dd[band]), 1)
    assert (hits[:w] == 1).all()


@pytest.mark.parametrize("dtype", DTYPE_IDS, ids=DTYPE_IDS.get)
@pytest.mark.parametrize("mode", list(corr.MODES))
@pytest.mark.parametrize("c,d", [(32, 48), (32, 1), (8, 64), (200, 65),
                                 (3, 700)])
def test_tile_plan_needs_no_opt_in_shared_memory(c, d, mode, dtype):
    plan = corr.tile_plan(513, c, d, dtype)
    assert plan.smem_bytes(mode) <= 48 * 1024
    assert plan.smem_bytes(mode) % 16 == 0 and (mode == "softargmax") == (
        plan.smem_bytes(mode) == 0)
    assert plan.nt_max == (8 if d <= 49 else 10)


def _store_runs(out, sm, runs, length, g_first, g_step, s_step, v):
    """`store_runs` of the kernel: 16-byte vectors where a whole vector
    lies in a run, single elements at a run's ragged ends; each element
    of ``out`` (NaN until then) written once."""
    nv = (length + 2 * v - 2) // v
    for i in range(runs * nv):
        r, k = divmod(i, nv)
        start = g_first + r * g_step
        e0 = k * v - start % v
        s = r * s_step + k * v
        if e0 >= 0 and e0 + v <= length:
            assert (start + e0) % v == 0 and s % v == 0
            assert np.isnan(out[start + e0:start + e0 + v]).all()
            out[start + e0:start + e0 + v] = sm[s:s + v]
        else:
            for e in range(v):
                if 0 <= e0 + e < length:
                    assert np.isnan(out[start + e0 + e])
                    out[start + e0 + e] = sm[s + e]


def _emulate(left, right, d, dtype, mode):
    """The kernel on the CPU, warp by warp and lane by lane, in float64:
    each warp's 16 x rows against its y tiles (zero outside [0, W) and
    past C), the band read out of the fragments, then the epilogue: output
    runs staged at their alignment shift (`dlast`, `hdw`), or each lane's
    running max / sum / weighted sum merged across the 4 lanes of a row
    (`softargmax`)."""
    n, h, w, c = left.shape
    plan = corr.tile_plan(w, c, d, dtype)
    pad = corr.WX + 8 * plan.nt_max + corr.DC * plan.d_chunks
    lf = np.zeros((n * h, pad + w + corr.WX, c))
    rf = np.zeros_like(lf)
    lf[:, pad:pad + w] = left.double().numpy().reshape(n * h, w, c)
    rf[:, pad:pad + w] = right.double().numpy().reshape(n * h, w, c)
    v = 16 // (plan.elt if mode == "hdw" else 4)
    out = np.full(n * h * w * (1 if mode == "softargmax" else d), np.nan)
    for nh in range(n * h):
        for xg in range(plan.x_groups):
            x0 = xg * corr.WX
            cols = min(corr.WX, w - x0)
            state = np.zeros((32, 2, 3))
            state[..., 0] = -np.finfo(np.float32).max
            for i in range(plan.d_chunks):
                d0, dc, nt = plan.chunk(i)
                yb = plan.y_start(x0, i)
                assert yb + pad >= 0
                acc = (lf[nh, pad + x0:pad + x0 + corr.WX]
                       @ rf[nh, pad + yb:pad + yb + 8 * nt].T)
                lane, _, row, col = _fragment(nt)
                k, y = row, yb + col
                dd = x0 + k - y - d0
                val = np.where(y < 0, 0.0, acc[row, col])
                band = (dd >= 0) & (dd < dc)
                if mode == "softargmax":
                    for ln in range(32):
                        for hh in range(2):
                            sel = band & (lane == ln) & (row // 8 == hh)
                            m, s, ws = state[ln, hh]
                            cm = max(m, val[sel].max(initial=m))
                            e = np.exp(val[sel] - cm)
                            state[ln, hh] = (cm, s * np.exp(m - cm) + e.sum(),
                                             ws * np.exp(m - cm)
                                             + ((d0 + dd[sel]) * e).sum())
                    continue
                keep = band & (k < cols)
                k, dd, val = k[keep], dd[keep], val[keep]
                sm = np.zeros(plan.warp_out(mode))
                if mode == "dlast" and plan.d_chunks == 1:
                    args = (1, cols * d, (nh * w + x0) * d, 0, 0)
                    pos = args[2] % v + k * d + dd
                elif mode == "dlast":
                    args = (cols, dc, (nh * w + x0) * d + d0, d, corr.DC + v)
                    pos = k * args[4] + (args[2] + k * args[3]) % v + dd
                else:
                    args = (dc, cols, (nh * d + d0) * w + x0, w, corr.WX + v)
                    pos = dd * args[4] + (args[2] + dd * args[3]) % v + k
                assert len(set(pos)) == len(pos) and pos.max() < len(sm)
                sm[pos] = val
                _store_runs(out, sm, *args, v)
            if mode == "softargmax":
                for o in (1, 2):  # the shuffles across the lanes of a row
                    other = state[np.arange(32) ^ o]
                    mn = np.maximum(state[..., 0], other[..., 0])
                    a = np.exp(state[..., 0] - mn)
                    b = np.exp(other[..., 0] - mn)
                    state = np.stack([mn, state[..., 1] * a + other[..., 1] * b,
                                      state[..., 2] * a + other[..., 2] * b],
                                     -1)
                for g in range(8):
                    for hh in range(2):
                        k = g + 8 * hh
                        if k < cols:
                            _, s, ws = state[4 * g, hh]
                            assert np.isnan(out[nh * w + x0 + k])
                            out[nh * w + x0 + k] = ws / s
    shape = {"dlast": (n, h, w, d), "hdw": (n, h, d, w),
             "softargmax": (n, h, w)}[mode]
    return torch.from_numpy(out.reshape(shape))


@pytest.mark.parametrize("dtype", DTYPE_IDS, ids=DTYPE_IDS.get)
@pytest.mark.parametrize("mode", list(corr.MODES))
@pytest.mark.parametrize("shape,d", [((1, 2, 70, 8), 6), ((2, 1, 65, 40), 49),
                                     ((1, 1, 5, 3), 9), ((1, 1, 37, 4), 130)],
                         ids=str)
def test_emulated_kernel_matches_plain(shape, d, mode, dtype):
    """Ragged W, two bf16 channel steps (C = 40), D > W, C not a multiple
    of 8 and three disparity chunks (D = 130): every output written once,
    by the right lane, at the right place."""
    tl, tr, _, _ = _scaled_pair(shape, dtype, seed=5)
    got = _emulate(tl, tr, d, dtype, mode)
    if mode == "softargmax":
        want = corr.corr_softargmax_plain(tl.float(), tr.float(), d)
    else:
        want = corr.corr_cost_volume_plain(tl.float(), tr.float(), d,
                                           layout=mode)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.double().numpy(), atol=1e-5)
