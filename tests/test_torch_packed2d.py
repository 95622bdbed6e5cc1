"""The port's H-packed 2D ops (`redtail_tpu_torch/ops/packed2d.py`), its
tensor space-to-depth pack and the corr kernel's grouped soft-argmax
against their JAX twins, on the CPU, at odd and even heights, with seeded
numpy inputs and random nonzero biases (zero biases hide boundary-row
bugs).

Both sides compute in full fp32 (JAX at HIGHEST): the ops are exact
re-expressions, so only the summation order differs: each op within 1e-5,
the resblock chain and the stem within 1e-4, the unpack within 1e-6 (pure
data movement on both sides). The grouped soft-argmax is the corr kernel's
plain version here (its CUDA route is held to it by `chip_smoke.py`'s
phase 3).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from redtail_tpu.ops import conv2d as jconv2d
from redtail_tpu.ops import elu as jelu
from redtail_tpu.ops import packed2d as J
from redtail_tpu.ops import space_to_depth as JS

from redtail_tpu_torch.kernels import corr_cost_volume as corr
from redtail_tpu_torch.ops import packed2d as P
from redtail_tpu_torch.ops.activations import elu
from redtail_tpu_torch.ops.space_to_depth import (
    S2D_IMPLS,
    conv5s2_kernel_to_s2d,
    space_to_depth2,
    use_s2d_stem,
)

ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the tier-1 run puts six test workers on the
    cores (restored after)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, 2))
    yield
    torch.set_num_threads(saved)


def _rand(shape, seed=0, scale=0.3):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _np(x):
    return np.asarray(x, np.float32)


def pack_aligned(x):
    n, h, w, c = x.shape
    hp = -(-h // 2)
    xp = np.pad(x, ((0, 0), (0, 2 * hp - h), (0, 0), (0, 0)))
    return np.concatenate([xp[:, 0::2], xp[:, 1::2]], axis=-1)


def pack_shifted(x):
    n, h, w, c = x.shape
    hp = -(-h // 2)
    xp = np.pad(x, ((0, 0), (1, 2 * hp + 1 - h), (0, 0), (0, 0)))
    return np.concatenate([xp[:, 0::2], xp[:, 1::2]], axis=-1)


@pytest.mark.parametrize("h", [8, 9, 10, 33])
@pytest.mark.parametrize("in_shifted", [False, True],
                         ids=["aligned_in", "shifted_in"])
@pytest.mark.parametrize("act", [None, "elu"])
def test_conv2d_hpacked_matches_jax(h, in_shifted, act):
    x = _rand((2, h, 13, 4))
    w = _rand((3, 3, 4, 5), 1)
    b = _rand((5,), 2)
    xp = pack_shifted(x) if in_shifted else pack_aligned(x)
    want = _np(J.conv2d_hpacked(jnp.asarray(xp), jnp.asarray(w),
                                jnp.asarray(b), h=h, in_shifted=in_shifted,
                                act=jelu if act else None))
    got = P.conv2d_hpacked(_t(xp), _t(w), _t(b), h=h, in_shifted=in_shifted,
                           act=elu if act else None)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    # and the unpacked conv it re-expresses, in the other convention
    ref = jconv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                  strides=(1, 1))
    ref = _np(jelu(ref) if act else ref)
    pack = pack_aligned if in_shifted else pack_shifted
    np.testing.assert_allclose(got.numpy(), pack(ref), atol=ATOL)


@pytest.mark.parametrize("h", [9, 12])
def test_conv2d_hpacked_keep_matches_jax(h):
    x = _rand((1, h, 11, 4))
    w = _rand((3, 3, 4, 6), 1)
    b = _rand((6,), 2)
    xp = pack_aligned(x)
    want = _np(J.conv2d_hpacked_keep(jnp.asarray(xp), jnp.asarray(w),
                                     jnp.asarray(b), h=h))
    got = P.conv2d_hpacked_keep(_t(xp), _t(w), _t(b), h=h)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_prepared_kernel_is_the_same_conv():
    """The model passes kernels derived once, at load (``kernel=``)."""
    x = pack_aligned(_rand((1, 9, 7, 4)))
    w, b = _rand((3, 3, 4, 4), 1), _rand((4,), 2)
    k = P.prepare(P.flip_kernel(_t(w)))
    a = P.conv2d_hpacked(_t(x), _t(w), _t(b), h=9, in_shifted=False)
    c = P.conv2d_hpacked(_t(x), None, _t(b), h=9, in_shifted=False, kernel=k)
    assert torch.equal(a, c)


@pytest.mark.parametrize("h", [8, 9, 33])
def test_hpacked_resblock_chain_matches_jax(h):
    """Two resblocks (4 convs, alternating conventions) + elu + skips,
    ending aligned: the towers' composition."""
    c = 6
    x = _rand((1, h, 15, c))
    ws = [_rand((3, 3, c, c), i + 1) for i in range(4)]
    bs = [_rand((c,), i + 10) for i in range(4)]

    def chain(xp, conv, act, add):
        for i in range(2):
            y = conv(xp, ws[2 * i], bs[2 * i], in_shifted=False, act=act)
            y = conv(y, ws[2 * i + 1], bs[2 * i + 1], in_shifted=True)
            xp = add(y, xp)
        return xp

    want = _np(chain(jnp.asarray(pack_aligned(x)),
                     lambda a, w, b, **kw: J.conv2d_hpacked(
                         a, jnp.asarray(w), jnp.asarray(b), h=h, **kw),
                     jelu, lambda y, s: jelu(y + s)))
    got = chain(_t(pack_aligned(x)),
                lambda a, w, b, **kw: P.conv2d_hpacked(a, _t(w), _t(b), h=h,
                                                       **kw),
                elu, lambda y, s: elu(y + s))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


@pytest.mark.parametrize("hw", [(18, 33), (17, 32), (33, 65)])
def test_conv1_s2d_hpacked_stem_matches_jax(hw):
    h, w = hw
    x = _rand((1, h, w, 3))
    w5 = _rand((5, 5, 3, 8), 1)
    b = _rand((8,), 2)
    h_half = -(-h // 2)
    k3 = conv5s2_kernel_to_s2d(w5, hw)
    want = _np(J.conv1_s2d_hpacked(JS.space_to_depth2(jnp.asarray(x)),
                                   jnp.asarray(k3), jnp.asarray(b),
                                   h_half=h_half, act=jelu))
    got = P.conv1_s2d_hpacked(space_to_depth2(_t(x)), _t(k3), _t(b),
                              h_half=h_half, act=elu)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    # the 5x5 stride-2 stem packed after the fact
    ref = _np(jelu(jconv2d(jnp.asarray(x), jnp.asarray(w5), jnp.asarray(b),
                           strides=(2, 2))))
    np.testing.assert_allclose(got.numpy(), pack_aligned(ref), atol=1e-4)


@pytest.mark.parametrize("h", [8, 9, 33])
def test_unpack_h2d_matches_jax(h):
    x = _rand((2, h, 13, 5))
    xp = pack_aligned(x)
    want = _np(J.unpack_h2d(jnp.asarray(xp), h))
    got = P.unpack_h2d(_t(xp), h)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    np.testing.assert_array_equal(got.numpy(), x)


@pytest.mark.parametrize("h", [8, 9])
@pytest.mark.parametrize("d", [1, 5, 16])
def test_grouped_corr_softargmax_matches_jax(h, d):
    """The corr kernel's grouped soft-argmax (its plain version here)
    against JAX's `corr_cost_volume_hpacked` + `softargmax_hpacked`, and
    against the port's twins of those two; an odd h has a pad row."""
    x_l, x_r = _rand((2, h, 20, 6), 1, 1.0), _rand((2, h, 20, 6), 2, 1.0)
    lp, rp = pack_aligned(x_l), pack_aligned(x_r)
    want = _np(J.softargmax_hpacked(J.corr_cost_volume_hpacked(
        jnp.asarray(lp), jnp.asarray(rp), d), h))
    vol = P.corr_cost_volume_hpacked(_t(lp), _t(rp), d)
    np.testing.assert_allclose(vol.numpy(), _np(J.corr_cost_volume_hpacked(
        jnp.asarray(lp), jnp.asarray(rp), d)), atol=ATOL)
    twins = P.softargmax_hpacked(vol, h)
    got = P.corr_softargmax_hpacked(_t(lp), _t(rp), d, h)
    assert got.shape == (2, -(-h // 2), 20, 2) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), twins.numpy(), atol=ATOL)
    if h % 2:
        assert (got[:, -1, :, 1] == 0).all()     # the pad row, re-zeroed
    # each group is the ungrouped soft-argmax of its rows
    for q in (0, 1):
        one = corr.corr_softargmax(_t(x_l[:, q::2]), _t(x_r[:, q::2]), d)
        np.testing.assert_allclose(got[:, :one.shape[1], :, q].numpy(),
                                   one.numpy(), atol=ATOL)


def test_grouped_corr_reads_channel_slices():
    """The head passes channel slices of the towers' map (pixel stride
    4 C): the same values as contiguous copies."""
    out = _t(_rand((1, 5, 17, 16), 3, 1.0))
    left, right = out[..., :8], out[..., 8:]
    got = corr.corr_softargmax(left, right, 6, groups=2, rows=9)
    want = corr.corr_softargmax(left.contiguous(), right.contiguous(), 6,
                                groups=2, rows=9)
    assert torch.equal(got, want)


def test_grouped_corr_refuses_bad_groups():
    x = torch.zeros(1, 2, 5, 6)
    with pytest.raises(ValueError, match="groups"):
        corr.corr_softargmax(x, x, 3, groups=4)


@pytest.mark.parametrize("impl", S2D_IMPLS)
@pytest.mark.parametrize("hw", [(7, 9), (8, 10)])
def test_space_to_depth2_matches_jax(impl, hw):
    x = _rand((2, *hw, 3), 5, 1.0)
    want = _np(JS.space_to_depth2(jnp.asarray(x), impl=impl))
    got = space_to_depth2(_t(x), impl=impl)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        space_to_depth2(_t(x).to(torch.bfloat16), impl=impl).float().numpy(),
        JS.space_to_depth2_np(x.astype(jnp.bfloat16)).astype(np.float32))


@pytest.mark.parametrize("value,on", [(None, True), ("1", True),
                                      ("0", False)])
def test_use_s2d_stem_reads_the_jax_switch(monkeypatch, value, on):
    if value is None:
        monkeypatch.delenv("REDTAIL_TPU_S2D", raising=False)
    else:
        monkeypatch.setenv("REDTAIL_TPU_S2D", value)
    assert use_s2d_stem() is on
    if value is not None:
        assert JS.use_s2d_stem() is on
