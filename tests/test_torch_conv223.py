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
