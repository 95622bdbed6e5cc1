"""The backward kernels' tilings, emulated on the CPU.

`kernels/corr_cost_volume.py:bwd_tile_plan` mirrors the tiling of
`csrc/corr_cost_volume_bwd.cu`, and `kernels/cost_volume_concat.py:
bwd_tile_plan` the division of `csrc/cost_volume_concat_bwd.cu`. For each,
every dL and dR element is owned by exactly one unit (a thread), and the
units' fp32 sums, emulated in numpy in the kernel's order (the corr
kernel's staged g_vol rows gvL / gvR, its R and L windows with their halos,
disparity chunks; the concat kernel's ascending d), equal the plain
versions within the gate of `tests/test_torch_train_kernels.py`: fp32
within 1e-5 of the largest magnitude, bf16 within one bf16 step more (both
round an fp32 sum once). The kernels themselves are held to the plain
versions on the card by `tests/test_torch_cuda.py` and `chip_smoke.py`.
"""

import numpy as np
import pytest
import torch

from redtail_tpu_torch.kernels import corr_cost_volume as corr
from redtail_tpu_torch.kernels import cost_volume_concat as concat

DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}
# (N, H, W, C), D: D < W, D == W, D > W, ragged W (not a multiple of the
# segment or the unit), W past one segment (segments with halos), C = 3, 8,
# 32, 40, D = 1, D past one disparity chunk, the training shape's C and D.
CORR_CASES = [((1, 2, 37, 8), 6), ((1, 2, 6, 8), 6), ((1, 2, 5, 4), 9),
              ((1, 1, 9, 3), 5), ((1, 2, 150, 32), 48), ((2, 1, 70, 32), 1),
              ((1, 1, 33, 40), 9), ((1, 1, 90, 16), 70),
              ((1, 1, 20, 8), 33), ((1, 1, 130, 32), 49)]
CONCAT_CASES = [((2, 3, 37, 8), 6), ((1, 2, 6, 8), 6), ((1, 2, 5, 4), 9),
                ((1, 2, 9, 3), 5), ((1, 2, 70, 32), 48), ((1, 1, 33, 40), 9),
                ((1, 2, 40, 8), 1), ((2, 1, 20, 5), 24)]


def _close(got, want, dtype):
    """The gate: fp32 within 1e-5 x (max + 1); bf16 one step more."""
    want = np.asarray(want, np.float32)
    atol = 1e-5 * (np.abs(want).max() + 1.0)
    err = np.abs(got - want)
    if dtype == torch.bfloat16:
        mag = np.maximum(np.abs(got), np.abs(want))
        atol = atol + np.exp2(np.floor(np.log2(np.maximum(mag, 2.0 ** -126)))
                              - 7)
    assert (err <= atol).all(), float(err.max())


def _bf16(a):
    """fp32 -> bf16 -> fp32 (round to nearest even), as the kernels store."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


# ------------------------------------------------------------------ corr

def _corr_inputs(shape, d, mode, dtype, seed):
    rs = np.random.RandomState(seed)
    n, h, w, c = shape
    left, right = (torch.from_numpy(rs.randn(*shape).astype(np.float32)
                                    / np.sqrt(c)).to(dtype) for _ in range(2))
    gshape = {"dlast": (n, h, w, d), "hdw": (n, h, d, w),
              "softargmax": (n, h, w)}[mode]
    g = torch.from_numpy(rs.randn(*gshape).astype(np.float32))
    return left, right, g.to(dtype) if mode == "hdw" else g


def _corr_gvol(left, right, g, d, mode):
    """g_vol (N, H, W, D) fp32 as the kernel stages it: the fused
    soft-argmax's g p (d - mu) over the recomputed volume, or the volume
    cotangent; the entries x < d pass no gradient."""
    if mode == "softargmax":
        vol = corr.corr_cost_volume_plain(left, right, d)
        p = torch.softmax(vol, dim=-1)
        idx = torch.arange(d, dtype=torch.float32)
        mu = (p * idx).sum(-1, keepdim=True)
        gv = g.float().unsqueeze(-1) * p * (idx - mu)
    elif mode == "dlast":
        gv = g.float()
    else:
        gv = g.float().permute(0, 1, 3, 2)
    w = left.shape[2]
    keep = torch.arange(w)[:, None] >= torch.arange(d)[None, :]
    return (gv * keep).numpy()


def _emulate_corr(left, right, gv, d, mode):
    """The kernel's blocks, chunks, staging and per-unit sums over
    ascending d (fp32), vectorised over a block's units."""
    n, h, w, c = left.shape
    plan = corr.bwd_tile_plan(w, c, d, left.dtype, mode)
    seg, db, cp = plan.seg, plan.db, plan.tc * plan.cg
    lf = left.float().numpy().reshape(n * h, w, c)
    rf = right.float().numpy().reshape(n * h, w, c)
    gv = gv.reshape(n * h, w, d)
    dl = np.zeros((n * h, w, c), np.float32)
    dr = np.zeros_like(dl)

    def stage(fmap, first):
        """seg + db rows from ``first`` of one row's map, zero outside
        [0, W) and past C."""
        out = np.zeros((seg + db, cp), np.float32)
        xs = first + np.arange(seg + db)
        ok = (xs >= 0) & (xs < w)
        out[ok, :c] = fmap[xs[ok]]
        return out

    for row in range(n * h):
        for s0 in range(0, w, seg):
            acc_l = np.zeros((seg, cp), np.float32)  # unit (x0, c0) at
            acc_r = np.zeros((seg, cp), np.float32)  # [x0 - s0 + i, c0 + k]
            for ci in range(plan.d_chunks):
                d0, dc, dbc = plan.chunk(ci)
                gvl = np.zeros((db, seg), np.float32)
                gvr = np.zeros((db, seg), np.float32)
                for dd in range(dc):
                    xs = s0 + np.arange(seg)
                    ok = xs < w
                    gvl[dd, ok] = gv[row, xs[ok], d0 + dd]
                    xd = xs + d0 + dd
                    ok = xd < w
                    gvr[dd, ok] = gv[row, xd[ok], d0 + dd]
                rs_ = stage(rf[row], s0 - d0 - db + 1)
                ls_ = stage(lf[row], s0 + d0)
                off = np.arange(seg)  # a unit's column x0 - s0 + i
                for k in range(0, dbc, 4):
                    for dd in range(4):
                        r = k + dd
                        # dL: win[i - dd + 3] = Rs row off0 + db - 4 - k
                        # + (i - dd + 3); dR: win[i + dd] = Ls row off0 + k
                        # + (i + dd), with off0 + i = off
                        acc_l += gvl[r][:, None] * rs_[off + db - 1 - r]
                        acc_r += gvr[r][:, None] * ls_[off + r]
            cols = min(seg, w - s0)
            dl[row, s0:s0 + cols] = acc_l[:cols, :c]
            dr[row, s0:s0 + cols] = acc_r[:cols, :c]
    return dl.reshape(left.shape), dr.reshape(left.shape)


@pytest.mark.parametrize("mode", ["softargmax", "dlast"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,d", CORR_CASES)
def test_corr_bwd_plan_owns_each_output_once(shape, d, dtype, mode):
    _, _, w, c = shape
    plan = corr.bwd_tile_plan(w, c, d, DTYPES[dtype], mode)
    assert plan.tc == corr.BWD_TC[mode]
    assert plan.seg % corr.BWD_TX == 0 and plan.seg <= -(-w // 8) * 8
    assert plan.smem_bytes() <= corr.BWD_SMEM_MAX
    assert plan.passes == 1 and plan.units <= corr.BWD_THREADS
    hits = {"dl": np.zeros((w, c), np.int32), "dr": np.zeros((w, c), np.int32)}
    for s0 in range(0, plan.segs * plan.seg, plan.seg):
        for u in range(plan.units):
            kind, off, c0 = plan.unit(u)
            xs = s0 + off + np.arange(corr.BWD_TX)
            cs = c0 + np.arange(plan.tc)
            xs, cs = xs[xs < w], cs[cs < c]
            np.add.at(hits[kind], np.ix_(xs, cs), 1)
    assert (hits["dl"] == 1).all() and (hits["dr"] == 1).all()


@pytest.mark.parametrize("mode", ["softargmax", "hdw"])
@pytest.mark.parametrize("shape,d", CORR_CASES)
def test_corr_bwd_plan_stages_each_units_reads(shape, d, mode):
    """Each chunk stages every row a unit's window reads and the g_vol of
    every x its dR sums reach: the segment and its halo, the D - 1 columns
    past it."""
    _, _, w, c = shape
    plan = corr.bwd_tile_plan(w, c, d, torch.bfloat16, mode)
    seg, db = plan.seg, plan.db
    for ci in range(plan.d_chunks):
        d0, dc, dbc = plan.chunk(ci)
        assert dbc % 4 == 0 and dc <= dbc <= db
        for off in range(0, seg, corr.BWD_TX):
            for k in range(0, dbc, 4):
                # dL window rows off + db - 4 - k + j, dR's off + k + j
                rows = [off + db - 4 - k, off + db - 4 - k + corr.BWD_TX + 2,
                        off + k, off + k + corr.BWD_TX + 2]
                assert min(rows) >= 0 and max(rows) < seg + db
        # dR of y in the segment reads g_vol at x = y + d: the halo
        xs = {y + dd for y in range(seg) for dd in range(d0, d0 + dc)}
        assert max(xs) <= seg + d - 2


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mode", list(corr.MODES))
@pytest.mark.parametrize("shape,d", CORR_CASES)
def test_corr_bwd_emulated_sums_match_plain(shape, d, mode, dtype):
    tdt = DTYPES[dtype]
    left, right, g = _corr_inputs(shape, d, mode, tdt, seed=d + len(mode))
    dl, dr = _emulate_corr(left, right, _corr_gvol(left, right, g, d, mode),
                           d, mode)
    if mode == "softargmax":
        want = corr.corr_softargmax_bwd_plain(left, right, g, d)
    else:
        want = corr.corr_cost_volume_bwd_plain(left, right, g, d,
                                               layout=mode)
    for got, ref in zip((dl, dr), want):
        assert ref.dtype == tdt
        _close(_bf16(got) if tdt == torch.bfloat16 else got,
               ref.float().numpy(), tdt)


def test_corr_bwd_plan_at_the_training_shape():
    """ResNet18-2D's training features: the fused soft-argmax's 4-channel
    units in 128-column segments (2 blocks a row, 2 an SM's 228 KB), the
    volume forms' 2-channel units in 64-column ones (4 a row, 4 an SM);
    256 units a block, one disparity chunk."""
    sa = corr.bwd_tile_plan(256, 32, 48, torch.bfloat16, "softargmax")
    vol = corr.bwd_tile_plan(256, 32, 48, torch.bfloat16, "dlast")
    for plan, seg, segs in ((sa, 128, 2), (vol, 64, 4)):
        assert (plan.seg, plan.segs, plan.units, plan.db, plan.d_chunks) == (
            seg, segs, 256, 48, 1)
    assert 57 * 1024 < sa.smem_bytes() < 113 * 1024
    assert 48 * 1024 < vol.smem_bytes() < 56 * 1024


def test_corr_bwd_plan_refuses_what_no_block_holds():
    with pytest.raises(ValueError, match="shared memory"):
        corr.bwd_tile_plan(64, 32, 20000, torch.float32)


# ---------------------------------------------------------------- concat

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,d", CONCAT_CASES)
def test_concat_bwd_plan_owns_each_output_once(shape, d, dtype):
    n, h, w, c = shape
    plan = concat.bwd_tile_plan(w, c, d, DTYPES[dtype])
    assert plan.word in (2, 4, 8, 16) and (c * plan.elt) % plan.word == 0
    assert plan.word == max(b for b in (2, 4, 8, 16)
                            if b >= plan.elt and (c * plan.elt) % b == 0)
    hits = np.zeros((n * h, w, c), np.int32)
    for u in range(n * h * plan.units_per_row):
        row, y, c0 = plan.unit(u)
        hits[row, y, c0:c0 + plan.v] += 1  # dL[y] and dR[y], one word each
    assert (hits == 1).all()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,d", CONCAT_CASES)
def test_concat_bwd_emulated_sums_match_plain(shape, d, dtype):
    """Each unit adds, over ascending d, the word of the left half of
    record (d, y) and of the right half of record (d, y + d), in fp32."""
    tdt = DTYPES[dtype]
    n, h, w, c = shape
    rs = np.random.RandomState(d)
    g = torch.from_numpy(rs.randn(n, d, h, w, 2 * c).astype(np.float32)
                         ).to(tdt)
    plan = concat.bwd_tile_plan(w, c, d, tdt)
    gf = g.float().numpy()
    dl = np.zeros((n, h, w, c), np.float32)
    dr = np.zeros_like(dl)
    for u in range(plan.units_per_row):  # one row's units, every row at once
        _, y, c0 = plan.unit(u)
        word = slice(c0, c0 + plan.v)
        right = slice(c + c0, c + c0 + plan.v)
        for dd in range(d):
            dl[:, :, y, word] += gf[:, dd, :, y, word]
            if y + dd < w:
                dr[:, :, y, word] += gf[:, dd, :, y + dd, right]
    want = concat.cost_volume_concat_bwd_plain(g, d)
    for got, ref in zip((dl, dr), want):
        assert ref.dtype == tdt
        _close(_bf16(got) if tdt == torch.bfloat16 else got,
               ref.float().numpy(), tdt)


def test_concat_bwd_plan_reads_16_bytes_at_the_training_shapes():
    for c in (8, 32):
        plan = concat.bwd_tile_plan(256, c, 24, torch.bfloat16)
        assert (plan.word, plan.v) == (16, 8)
    assert concat.bwd_tile_plan(256, 8, 24, torch.float32).v == 4


@pytest.mark.parametrize("offset,word", [(0, 16), (4, 8), (2, 4), (1, 2)])
def test_concat_bwd_word_narrows_to_the_storage_alignment(offset, word,
                                                          monkeypatch):
    """A cotangent whose storage offset breaks the plan's 16-byte word
    (bf16, C = 8) is read in the widest word its address allows; the CUDA
    route is taken with a stand-in library that records the launch."""
    calls = []

    class Lib:
        def cost_volume_concat_bwd_launch(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(concat, "_on_cpu", lambda *args: False)
    monkeypatch.setattr(concat, "_lib_bwd", lambda: Lib())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0}))
    n, d, h, w, c = 1, 3, 2, 5, 8
    flat = torch.zeros(offset + n * d * h * w * 2 * c, dtype=torch.bfloat16)
    g = flat[offset:].view(n, d, h, w, 2 * c)
    concat.cost_volume_concat_bwd(g, d)
    assert len(calls) == 1 and calls[0][0] == g.data_ptr()
    if flat.data_ptr() % 16 == 0:  # the CPU allocator's alignment
        assert calls[0][9] == word
    assert calls[0][9] == next(b for b in (16, 8, 4, 2)
                               if g.data_ptr() % b == 0)
