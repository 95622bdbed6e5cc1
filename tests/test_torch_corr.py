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

