"""The port's packed 3D ops (`redtail_tpu_torch/ops/packed3d.py`) and its
D-folded transposed conv (`ops/convolution.py:conv3d_transpose_dfold`)
against their JAX twins, on the CPU, at the grids of
`tests/test_packed3d.py` (odd and even D/H/W: both TF-SAME low-pad
parities), with seeded numpy inputs and random nonzero biases.

Both sides compute in full fp32 (JAX at HIGHEST): the ops are exact
re-expressions, so only the summation order differs, and every op is held
within 1e-5. The in-shifted, H-packed conv runs the conv223 kernel's plain
version here (`tests/test_torch_conv223.py` holds it against the Pallas
kernel).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from redtail_tpu.ops import conv3d as jconv3d
from redtail_tpu.ops import conv3d_transpose as jconv3d_transpose
from redtail_tpu.ops import packed3d as J
from redtail_tpu.ops.convolution import (
    conv3d_transpose_dfold as jconv3d_transpose_dfold,
)
from redtail_tpu.ops.softargmax import softargmin as jsoftargmin

from redtail_tpu_torch.ops import packed3d as P
from redtail_tpu_torch.ops.convolution import conv3d_transpose_dfold
from redtail_tpu_torch.ops.softargmax import softargmin

ATOL = 1e-5  # fp32 on both sides, summation order only


def _rand(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _np(x):
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dhw", [(8, 10, 12), (7, 9, 11), (6, 9, 12),
                                 (5, 6, 7)], ids=str)
@pytest.mark.parametrize("packed_h", [True, False])
@pytest.mark.parametrize("shifted", [True, False])
def test_pack_unpack_match_jax(dhw, packed_h, shifted):
    x = _rand((2, *dhw, 3))
    want = _np(J.pack(jnp.asarray(x), d=True, h=packed_h, shifted=shifted))
    got = P.pack(_t(x), d=True, h=packed_h, shifted=shifted)
    np.testing.assert_array_equal(got.numpy(), want)   # pure data movement
    back = P.unpack_ref(got, dhw, d=True, h=packed_h, shifted=shifted)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        back.numpy(), _np(J.unpack_ref(jnp.asarray(want), dhw, d=True,
                                       h=packed_h, shifted=shifted)))


@pytest.mark.parametrize("dhw", [(8, 10, 12), (7, 9, 11), (6, 9, 12)],
                         ids=str)
@pytest.mark.parametrize("packed_h", [True, False])
def test_unpack_conv_matches_jax(dhw, packed_h):
    x = _rand((2, *dhw, 4))
    xp = J.pack(jnp.asarray(x), d=True, h=packed_h)
    want = _np(J.unpack_conv(xp, dhw, packed_h=packed_h))
    got = P.unpack_conv(_t(xp), dhw, packed_h=packed_h)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("dhw", [(8, 10, 12), (7, 9, 11), (6, 9, 12)],
                         ids=str)
def test_unpack_h_conv_matches_jax(dhw):
    x = _rand((2, *dhw, 4))
    xp = J.pack(jnp.asarray(x), d=True, h=True)
    got = P.unpack_h_conv(_t(xp), dhw)
    np.testing.assert_allclose(got.numpy(), _np(J.unpack_h_conv(xp, dhw)),
                               atol=ATOL)
    np.testing.assert_array_equal(got.numpy(), _np(J.pack(jnp.asarray(x))))


@pytest.mark.parametrize("dhw", [(8, 10, 12), (7, 9, 11), (6, 9, 13),
                                 (5, 8, 7)], ids=str)
@pytest.mark.parametrize("packed_h", [True, False])
@pytest.mark.parametrize("in_shifted", [True, False])
def test_conv3d_packed_matches_jax(dhw, packed_h, in_shifted):
    x = _rand((2, *dhw, 4))
    w = _rand((3, 3, 3, 4, 5), 1) * 0.2
    b = _rand((5,), 2)
    xp = J.pack(jnp.asarray(x), d=True, h=packed_h, shifted=in_shifted)
    want = _np(J.conv3d_packed(xp, w, b, full_spatial=dhw, packed_h=packed_h,
                               in_shifted=in_shifted))
    got = P.conv3d_packed(_t(xp), _t(w), _t(b), full_spatial=dhw,
                          packed_h=packed_h, in_shifted=in_shifted)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    # and the function it re-expresses: the unpacked conv3d
    np.testing.assert_allclose(
        P.unpack_ref(got, dhw, d=True, h=packed_h,
                     shifted=not in_shifted).numpy(),
        _np(jconv3d(x, w, b)), atol=1e-4)


def test_conv3d_packed_chain_matches_jax():
    """shifted -> conv -> aligned -> conv -> shifted, as
    `tests/test_packed3d.py::test_conv3d_packed_chain_alternates`."""
    dhw = (7, 9, 11)
    x = _rand((1, *dhw, 4))
    w1, w2 = _rand((3, 3, 3, 4, 6), 1) * 0.2, _rand((3, 3, 3, 6, 4), 2) * 0.2
    b1, b2 = _rand((6,), 3), _rand((4,), 4)
    xp = J.pack(jnp.asarray(x), d=True, h=True, shifted=True)
    want = J.conv3d_packed(J.conv3d_packed(xp, w1, b1, full_spatial=dhw),
                           w2, b2, full_spatial=dhw, in_shifted=False)
    got = P.conv3d_packed(P.conv3d_packed(_t(xp), _t(w1), _t(b1),
                                          full_spatial=dhw),
                          _t(w2), _t(b2), full_spatial=dhw, in_shifted=False)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL)


@pytest.mark.parametrize("dhw", [(8, 10, 12), (7, 9, 11), (6, 9, 13),
                                 (17, 21, 15)], ids=str)
@pytest.mark.parametrize("packed_h", [True, False])
def test_conv3d_packed_down_matches_jax(dhw, packed_h):
    x = _rand((2, *dhw, 4))
    w = _rand((3, 3, 3, 4, 5), 1) * 0.2
    b = _rand((5,), 2)
    xp = J.pack(jnp.asarray(x), d=True, h=packed_h)
    want = _np(J.conv3d_packed_down(xp, w, b, full_spatial=dhw,
                                    packed_h=packed_h))
    got = P.conv3d_packed_down(_t(xp), _t(w), _t(b), full_spatial=dhw,
                               packed_h=packed_h)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("dhw", [(8, 10, 12), (7, 9, 11), (17, 21, 15),
                                 (12, 9, 13)], ids=str)
def test_conv3d_packed_down_unpack_matches_jax(dhw):
    x = _rand((2, *dhw, 4))
    w = _rand((3, 3, 3, 4, 6), 1) * 0.2
    b = _rand((6,), 2)
    xp = J.pack(jnp.asarray(x), d=True, h=False)
    want = _np(J.conv3d_packed_down_unpack(xp, w, b, full_spatial=dhw))
    got = P.conv3d_packed_down_unpack(_t(xp), _t(w), _t(b), full_spatial=dhw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("in_dhw,out_dhw", [
    ((4, 5, 6), (8, 10, 12)),
    ((4, 5, 6), (7, 9, 11)),
    ((5, 3, 7), (9, 6, 13)),
], ids=str)
@pytest.mark.parametrize("pack_h", [True, False])
@pytest.mark.parametrize("in_packed_d", [True, False])
def test_deconv3d_packed_matches_jax(in_dhw, out_dhw, pack_h, in_packed_d):
    x = _rand((2, *in_dhw, 5))
    w = _rand((3, 3, 3, 4, 5), 1) * 0.2
    b = _rand((4,), 2)
    xin = J.pack(jnp.asarray(x), d=True, h=False) if in_packed_d \
        else jnp.asarray(x)
    want = _np(J.deconv3d_packed(xin, w, b, out_spatial=out_dhw,
                                 in_packed_d=in_packed_d, pack_h=pack_h))
    got = P.deconv3d_packed(_t(xin), _t(w), _t(b), out_spatial=out_dhw,
                            in_packed_d=in_packed_d, pack_h=pack_h)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    np.testing.assert_allclose(
        P.unpack_ref(got, out_dhw, d=True, h=pack_h).numpy(),
        _np(jconv3d_transpose(x, w, b, out_spatial=out_dhw,
                              strides=(2, 2, 2))), atol=1e-4)


def test_prepared_kernel_is_the_on_the_fly_one():
    """The model passes kernels derived at load (``kernel=``); they give
    the op's own result."""
    dhw = (7, 9, 11)
    x = P.pack(_t(_rand((1, *dhw, 4))), d=True, h=True)
    w, b = _t(_rand((3, 3, 3, 4, 5), 1) * 0.2), _t(_rand((5,), 2))
    k = P.prepare(P.conv3d_packed_down_kernel(w, full_spatial=dhw), "conv")
    torch.testing.assert_close(
        P.conv3d_packed_down(x, None, b, full_spatial=dhw, kernel=k),
        P.conv3d_packed_down(x, w, b, full_spatial=dhw), rtol=0, atol=0)
    with pytest.raises(ValueError, match="kernel form"):
        P.prepare(k, "dense")


# --------------------------------------------------------------- dfold


def _dfold_inputs(out_spatial, in_d, packed_h, c_out=1):
    in_dhw = (in_d, -(-out_spatial[1] // 2), -(-out_spatial[2] // 2))
    x = _rand((2, *in_dhw, 3))
    w = _rand((3, 3, 3, c_out, 3), 1) * 0.2
    b = _rand((c_out,), 2)
    return x, J.pack(jnp.asarray(x), d=True, h=packed_h), w, b


@pytest.mark.parametrize("out_spatial,in_d", [((96, 7, 9), 48),
                                              ((67, 6, 8), 34),
                                              ((12, 9, 11), 6)], ids=str)
@pytest.mark.parametrize("layout", ["ndhwc", "dlast"])
def test_dfold_d_packed_matches_jax(out_spatial, in_d, layout):
    x, xp, w, b = _dfold_inputs(out_spatial, in_d, False)
    want = _np(jconv3d_transpose_dfold(xp, w, b, out_spatial=out_spatial,
                                       d_packed=True, layout=layout))
    got = conv3d_transpose_dfold(_t(xp), _t(w), _t(b),
                                 out_spatial=out_spatial, d_packed=True,
                                 layout=layout)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    unpacked = conv3d_transpose_dfold(_t(x), _t(w), _t(b),
                                      out_spatial=out_spatial, layout=layout)
    np.testing.assert_allclose(unpacked.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("out_spatial,in_d", [((96, 7, 9), 48),
                                              ((96, 8, 10), 48),
                                              ((67, 6, 8), 34),
                                              ((12, 9, 11), 6),
                                              ((11, 10, 13), 6)], ids=str)
@pytest.mark.parametrize("layout", ["ndhwc", "dlast"])
def test_dfold_h_packed_matches_jax(out_spatial, in_d, layout):
    _, xp, w, b = _dfold_inputs(out_spatial, in_d, True)
    want = _np(jconv3d_transpose_dfold(xp, w, b, out_spatial=out_spatial,
                                       d_packed=True, h_packed=True,
                                       layout=layout))
    got = conv3d_transpose_dfold(_t(xp), _t(w), _t(b),
                                 out_spatial=out_spatial, d_packed=True,
                                 h_packed=True, layout=layout)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("d_block", [5, 16, 40])
def test_dfold_d_block_matches_jax(d_block):
    """Any block split gives the same function; c_out = 2 exercises the
    (d, c) output order."""
    out_spatial = (30, 9, 8)
    _, xp, w, b = _dfold_inputs(out_spatial, 15, True, c_out=2)
    want = _np(jconv3d_transpose_dfold(xp, w, b, out_spatial=out_spatial,
                                       d_packed=True, h_packed=True,
                                       d_block=d_block))
    got = conv3d_transpose_dfold(_t(xp), _t(w), _t(b),
                                 out_spatial=out_spatial, d_packed=True,
                                 h_packed=True, d_block=d_block)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("out_spatial,in_d,h_packed",
                         [((96, 7, 9), 48, True), ((96, 8, 10), 48, False),
                          ((11, 10, 13), 6, True)], ids=str)
def test_dfold_reduce_matches_jax(out_spatial, in_d, h_packed):
    """reduce= (the fused soft-argmin) per parity map before the weaves:
    against the port's own woven dlast volume (the weaves are exact
    interleaves, so only the soft-argmin's reassociation differs) and
    against JAX's reduce=."""
    _, xp, w, b = _dfold_inputs(out_spatial, in_d, h_packed)
    kw = dict(out_spatial=out_spatial, d_packed=True, h_packed=h_packed,
              layout="dlast")
    dlast = conv3d_transpose_dfold(_t(xp), _t(w), _t(b), **kw)
    got = conv3d_transpose_dfold(
        _t(xp), _t(w), _t(b), reduce=lambda t: softargmin(t[..., 0], axis=-1),
        **kw)
    assert got.shape == (2, *out_spatial[1:])
    np.testing.assert_allclose(got.numpy(),
                               softargmin(dlast[..., 0], axis=-1).numpy(),
                               atol=1e-6, rtol=0)
    want = _np(jconv3d_transpose_dfold(
        xp, w, b, reduce=lambda t: jsoftargmin(t[..., 0], axis=-1), **kw))
    # the soft-argmin over up to 96 depths weighs each input's ~5e-7 fp32
    # reassociation by the depth index: 1e-4 in depth units (of 96)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_dfold_rejects_bad_options():
    _, xp, w, b = _dfold_inputs((12, 9, 11), 6, True)
    x = _t(xp)
    for kw, match in (({"h_packed": True}, "h_packed"),
                      ({"d_packed": True, "layout": "ncdhw"}, "layout"),
                      ({"d_packed": True, "reduce": sum}, "reduce")):
        with pytest.raises(ValueError, match=match):
            conv3d_transpose_dfold(x, _t(w), _t(b), out_spatial=(12, 9, 11),
                                   **kw)
