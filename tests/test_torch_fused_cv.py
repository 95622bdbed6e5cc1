"""The port's fused cost volume + conv3D_1 against the JAX package's, on the
CPU.

On the CPU the assembly kernel's wrapper runs its plain PyTorch version
(`kernels/fused_cv_emit.py`). The port's `cost_volume_conv3d` is held
against JAX's XLA form (`emit="full"`), against the unfused
conv3d(cost_volume) it factors, and against the TPU kernel it replaces,
`emit_dh_shifted_pallas` (interpret mode, selected as
`tests/test_fused_cv_emit_pallas.py` selects it), after repacking the
port's (N, D, H, W, K) output into that kernel's dh-shifted layout here in
the test. The CUDA kernel is held against the plain version on the card by
`tests/test_torch_cuda.py` and `chip_smoke.py`.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import redtail_tpu.ops.fused_cost_volume_conv as jfcv
from redtail_tpu.kernels.cost_volume_pallas import cost_volume_pallas
from redtail_tpu.ops import conv3d as jconv3d
from redtail_tpu.ops import cost_volume as jcost_volume
from redtail_tpu.ops import elu as jelu

from redtail_tpu_torch.kernels import fused_cv_emit as emit
from redtail_tpu_torch.ops import cost_volume_conv3d, elu
from test_fused_cv_emit_pallas import CASES as PALLAS_CASES
from test_torch_cuda import EMIT_SHAPES

# (n, h, w, c, D, k): tests/test_ops_golden.py:177-178's pair, odd D.
XLA_SHAPES = [(2, 10, 19, 5, 7, 4), (1, 12, 33, 8, 12, 6),
              (1, 9, 17, 4, 5, 3)]
# D >= W (JAX's XLA forms need D <= W; the Pallas volume takes any D).
WIDE_D_SHAPES = [(1, 5, 6, 3, 9, 2), (1, 4, 6, 3, 6, 3)]


def _inputs(n, h, w, c, k, seed, wscale=1.0):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, h, w, c).astype(np.float32),
            rs.randn(n, h, w, c).astype(np.float32),
            (rs.randn(3, 3, 3, 2 * c, k) * wscale).astype(np.float32),
            rs.randn(k).astype(np.float32))


def _port(left, right, w, b, d, act=elu, dtype=torch.float32):
    t = [torch.from_numpy(a).to(dtype) for a in (left, right, w)]
    return cost_volume_conv3d(*t, torch.from_numpy(b), d, act=act)


@pytest.mark.parametrize("shape", XLA_SHAPES, ids=str)
def test_matches_xla_fused_and_unfused(shape):
    n, h, w_, c, d, k = shape
    left, right, w, b = _inputs(n, h, w_, c, k, seed=0)
    got = _port(left, right, w, b, d).numpy()
    assert got.shape == (n, d, h, w_, k)
    fused = np.asarray(jelu(jfcv.cost_volume_conv3d(left, right, w, b, d)))
    unfused = np.asarray(jelu(jconv3d(jcost_volume(left, right, d), w, b)))
    # fp32 on both sides (JAX at HIGHEST): summation order only; the JAX
    # package's own exactness gate (tests/test_ops_golden.py:193)
    np.testing.assert_allclose(got, fused, atol=1e-4)
    np.testing.assert_allclose(got, unfused, atol=1e-4)


@pytest.mark.parametrize("shape", WIDE_D_SHAPES, ids=str)
def test_wide_disparity_matches_dense_conv3d(shape):
    n, h, w_, c, d, k = shape
    left, right, w, b = _inputs(n, h, w_, c, k, seed=1)
    want = np.asarray(jelu(jconv3d(cost_volume_pallas(left, right, d), w,
                                   b)))
    # fp32 summation order only, as above
    np.testing.assert_allclose(_port(left, right, w, b, d).numpy(), want,
                               atol=1e-4)


def test_without_activation():
    left, right, w, b = _inputs(1, 6, 11, 3, 2, seed=2)
    got = _port(left, right, w, b, 5, act=None).numpy()
    want = np.asarray(jfcv.cost_volume_conv3d(left, right, w, b, 5))
    np.testing.assert_allclose(got, want, atol=1e-4)  # fp32 order only


def _repack_dh_shifted(full):
    """(N, D, H, W, K) -> the Pallas kernel's (N, Dp+1, Hp+1, W, 4K): slot
    ``ad`` holds d = 2ad-1+qd, row slot ``b`` holds row 2b-1+qh, channel
    group qh*2+qd, zero where d or the row is out of range
    (`redtail_tpu/ops/fused_cost_volume_conv.py:176-235`)."""
    n, d_n, h, w, k = full.shape
    out = np.zeros((n, (d_n + 1) // 2 + 1, (h + 1) // 2 + 1, w, 4 * k),
                   np.float32)
    for ad in range(out.shape[1]):
        for b in range(out.shape[2]):
            for qh in (0, 1):
                for qd in (0, 1):
                    d, row, g = 2 * ad - 1 + qd, 2 * b - 1 + qh, 2 * qh + qd
                    if 0 <= d < d_n and 0 <= row < h:
                        out[:, ad, b, :, g * k:(g + 1) * k] = full[:, d, row]
    return out


def _pallas(monkeypatch, left, right, w, b, d):
    monkeypatch.setattr(jfcv, "use_pallas_cv_emit", lambda: True)
    return np.asarray(jfcv.cost_volume_conv3d(left, right, w, b, d,
                                              act=jelu, emit="dh_shifted"),
                      np.float32)


@pytest.mark.parametrize("h,w,c,k,dmax", PALLAS_CASES)
def test_matches_pallas_emit_kernel_fp32(monkeypatch, h, w, c, k, dmax):
    left, right, wts, b = _inputs(1, h, w, c, k, seed=h, wscale=0.2)
    want = _pallas(monkeypatch, left, right, wts, b, dmax)
    got = _repack_dh_shifted(_port(left, right, wts, b, dmax).numpy())
    assert got.shape == want.shape
    # both accumulate fp32 and apply ELU in fp32: summation order only
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_matches_pallas_emit_kernel_bf16(monkeypatch):
    h, w, c, k, dmax = PALLAS_CASES[0]
    left, right, wts, b = _inputs(1, h, w, c, k, seed=3, wscale=0.2)
    j = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    want = _pallas(monkeypatch, j(left), j(right), j(wts), b, dmax)
    got = _port(left, right, wts, b, dmax, dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    # Both round the 2D conv maps to bf16 and the fp32 sum once; the gate
    # is the Pallas test's own bf16 gate (test_fused_cv_emit_pallas.py:57)
    np.testing.assert_allclose(_repack_dh_shifted(got.float().numpy()), want,
                               atol=0.05, rtol=0.05)


def test_dh_shifted_emission_raises():
    left, right, w, b = (torch.from_numpy(a)
                         for a in _inputs(1, 4, 7, 2, 3, seed=4))
    with pytest.raises(NotImplementedError, match="module queue item 11"):
        cost_volume_conv3d(left, right, w, b, 4, act=elu, emit="dh_shifted")


@pytest.mark.parametrize("elu_on", [True, False], ids=["elu", "linear"])
@pytest.mark.parametrize("shape,d", EMIT_SHAPES)
def test_edge_shapes_match_dense_conv3d(shape, d, elu_on):
    """The card tests' edge shapes (ragged W, odd D, D > W, D == W, D = 1,
    batch 2) against JAX's dense conv3d over the Pallas volume."""
    n, h, w_, k = shape
    left, right, w, b = _inputs(n, h, w_, 3, k, seed=5)
    want = jconv3d(cost_volume_pallas(left, right, d), w, b)
    want = np.asarray(jelu(want) if elu_on else want)
    got = _port(left, right, w, b, d, act=elu if elu_on else None).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)  # fp32 order only


def test_cpu_takes_plain_version_without_counting():
    rs = np.random.RandomState(6)
    la = torch.from_numpy(rs.randn(1, 3, 8, 6).astype(np.float32))
    rb = torch.from_numpy(rs.randn(1, 3, 8, 12).astype(np.float32))
    before = emit.fused_cv_emit.launches
    got = emit.fused_cv_emit(la, rb, None, 4)
    assert emit.fused_cv_emit.launches == before
    torch.testing.assert_close(got, emit.fused_cv_emit_plain(la, rb, None, 4),
                               rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["dtype", "mixed_dtype", "channels", "hw",
                                 "bias", "max_disp", "empty", "device"])
def test_wrapper_rejects_bad_input(bad):
    rs = np.random.RandomState(7)
    la = torch.from_numpy(rs.randn(1, 3, 8, 6).astype(np.float32))
    rb = torch.from_numpy(rs.randn(1, 3, 8, 12).astype(np.float32))
    b, d = torch.zeros(2), 4
    if bad == "dtype":
        la, rb = la.half(), rb.half()
    elif bad == "mixed_dtype":
        rb = rb.bfloat16()
    elif bad == "channels":
        rb = rb[..., :9]
    elif bad == "hw":
        rb = rb[:, :, :7]
    elif bad == "bias":
        b = torch.zeros(3)
    elif bad == "max_disp":
        d = 0
    elif bad == "empty":
        la, rb = la[:, :0], rb[:, :0]
    elif bad == "device":
        rb = rb.to("meta")
    with pytest.raises((TypeError, ValueError)):
        emit.fused_cv_emit(la, rb, b, d)
