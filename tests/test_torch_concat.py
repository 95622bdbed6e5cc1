"""The port's concat cost volume against the JAX package's, on the CPU.

On the CPU the wrapper runs the kernel's plain PyTorch version; it is held
against the Pallas kernel it replaces (`cost_volume_pallas`, in interpret
mode as `tests/test_kernels.py` runs it), the JAX XLA volume
(`ops.cost_volume`) and the in-repo golden fixtures. The volume is a pure
copy, so every comparison is exact (tolerance 0). The CUDA kernel itself
is held against the plain version on the card, bit for bit, by
`tests/test_torch_cuda.py` and `chip_smoke.py`.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from redtail_tpu.kernels.cost_volume_pallas import cost_volume_pallas
from redtail_tpu.ops import cost_volume as jcost_volume

from conftest import LOCAL_GOLDEN_DIR
from redtail_tpu_torch.io import read_bin
from redtail_tpu_torch.kernels import cost_volume_concat as concat
from redtail_tpu_torch.ops import cost_volume
from test_torch_cuda import CONCAT_SHAPES

DTYPES = {"fp32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _pair(shape, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(*shape).astype(np.float32),
            rs.randn(*shape).astype(np.float32))


def _as(a, dtype):
    tdt, jdt = DTYPES[dtype]
    return torch.from_numpy(a).to(tdt), jnp.asarray(a, jdt)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape,d", CONCAT_SHAPES)
def test_matches_pallas_kernel(shape, d, dtype):
    (lt, lj), (rt, rj) = (_as(a, dtype) for a in _pair(shape))
    want = cost_volume_pallas(lj, rj, d)   # (N, D, H, W, 2C)
    got = cost_volume(lt, rt, d)
    assert got.dtype == DTYPES[dtype][0]
    assert tuple(got.shape) == want.shape == (shape[0], d, *shape[1:3],
                                              2 * shape[3])
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape,d", [s for s in CONCAT_SHAPES
                                     if s[1] <= s[0][2]])
def test_matches_xla_volume(shape, d, dtype):
    """(The XLA slices form needs D <= W; the D > W case is the Pallas
    test's.)"""
    (lt, lj), (rt, rj) = (_as(a, dtype) for a in _pair(shape, seed=1))
    np.testing.assert_array_equal(_np(cost_volume(lt, rt, d)),
                                  _np(jcost_volume(lj, rj, d)))


@pytest.mark.parametrize("case,d", [("01", 2), ("02", 12)])
def test_matches_golden_fixture(case, d):
    def nhwc(name):
        return torch.from_numpy(np.transpose(
            read_bin(LOCAL_GOLDEN_DIR / f"cost_vol_{case}_{name}.bin"),
            (0, 2, 3, 1)))

    want = read_bin(LOCAL_GOLDEN_DIR / f"cost_vol_{case}_cv.bin")  # NDCHW
    got = cost_volume(nhwc("l"), nhwc("r"), d)                      # NDHWC
    # same gate as tests/test_ops_golden.py::test_cost_volume_golden
    np.testing.assert_array_equal(got.permute(0, 1, 4, 2, 3).numpy(), want)


def test_cpu_takes_plain_version_without_counting():
    left, right = (torch.from_numpy(a) for a in _pair((1, 2, 9, 3)))
    before = concat.cost_volume_concat.launches
    got = concat.cost_volume_concat(left, right, 4)
    assert concat.cost_volume_concat.launches == before
    torch.testing.assert_close(
        got, concat.cost_volume_concat_plain(left, right, 4), rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["dtype", "mixed_dtype", "shape", "rank",
                                 "max_disp", "empty", "device"])
def test_wrapper_rejects_bad_input(bad):
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
        d = 0
    elif bad == "empty":
        left, right = left[:, :0], right[:, :0]
    elif bad == "device":
        right = right.to("meta")
    with pytest.raises((TypeError, ValueError)):
        concat.cost_volume_concat(left, right, d)
