"""The training path's gradients, on the CPU, against the JAX package's.

- The correlation volume's backward (`corr_cost_volume_bwd_plain`, both
  layouts, and the fused soft-argmax's `corr_softargmax_bwd_plain`)
  against `jax.vjp` of the Pallas kernel's `custom_vjp` (interpret mode, as
  `tests/test_kernels.py` runs it), of `corr_cost_volume_dlast` and of
  `corr_cost_volume_dlast` + `softargmax`; D > W through the Pallas VJP,
  since the XLA volume fails there.
- The concat volume's backward against `jax.vjp` of
  `ops.cost_volume.cost_volume` (D <= W: the XLA volume fails past W too).
- The round-once convs' gradients (`ops/convolution.py:_ConvSum`) against
  `jax.vjp` of the JAX convs (`dilated_conv`, the mixed form's
  `custom_vjp` in bf16): 2D, 3D and both transposes.

Gates: fp32 within 1e-5 of the largest magnitude (summation order only).
bf16: the kernels' backwards within one bf16 step (of the larger
magnitude) plus that of the fp32-accumulated result, JAX's VJP of the
same bf16 values held in fp32 (the port rounds that fp32 sum once; JAX's
bf16 Pallas route also rounds its volume to bf16 before the soft-argmax,
another function); the convs within one step of JAX's bf16 mixed-form
VJP, which also rounds one fp32 sum once. The CPU wrappers run these
plain backwards through their autograd functions; `tests/test_torch_cuda.py` holds the
backward kernels to them on the card.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from redtail_tpu.kernels import corr_cost_volume_pallas
from redtail_tpu.ops import convolution as jconv
from redtail_tpu.ops.cost_volume import cost_volume as jcost_volume
from redtail_tpu.ops.cost_volume import corr_cost_volume_dlast as jdlast
from redtail_tpu.ops.softargmax import softargmax as jsoftargmax

from redtail_tpu_torch.kernels import corr_cost_volume as corr
from redtail_tpu_torch.kernels import cost_volume_concat as concat
from redtail_tpu_torch.ops import convolution as conv

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# (N, H, W, C), D: D < W, ragged, D == W, D > W
SHAPES = [((2, 3, 13, 8), 5), ((1, 2, 9, 3), 9), ((1, 2, 6, 4), 10)]


def _np(a):
    return np.asarray(a.float().numpy() if isinstance(a, torch.Tensor)
                      else np.asarray(a, np.float32), np.float32)


def assert_grad_close(got, want):
    got, want = (got, want)
    g, w = _np(got), _np(want)
    assert g.shape == w.shape
    atol = 1e-5 * (np.abs(w).max() + 1.0)
    if isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16:
        mag = np.maximum(np.abs(g), np.abs(w))
        ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 2.0 ** -126))) - 7)
        bad = np.abs(g - w) > ulp + atol
        assert not bad.any(), f"{bad.sum()} elements past one bf16 step"
    else:
        np.testing.assert_allclose(g, w, rtol=0, atol=atol)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """A few intra-op threads: the tier-1 run puts six test workers on the
    cores, and oversubscribed CPU convs run an order of magnitude slower
    (restored after)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, 2))
    yield
    torch.set_num_threads(saved)


def jax_vjp(fn, *args):
    """``fn``'s VJP at ``args`` applied to a cotangent, jitted: one compile
    costs less than JAX's op-by-op eager dispatch of the sliced volumes."""
    return jax.jit(lambda g: jax.vjp(fn, *args)[1](g))


def _inputs(shape, seed=0, dtype="float32"):
    """Features scaled by 1/sqrt(C) (an O(1) volume), at values of
    ``dtype``, held in fp32, and the generator for the cotangent."""
    rs = np.random.RandomState(seed)
    left, right = (torch.from_numpy(rs.randn(*shape).astype(np.float32)
                                    / np.sqrt(shape[-1]))
                   .to(DTYPES[dtype][0]).float().numpy() for _ in range(2))
    return left, right, rs


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,d", SHAPES)
def test_corr_hdw_bwd_matches_pallas_vjp(shape, d, dtype):
    tdt = DTYPES[dtype][0]
    left, right, rs = _inputs(shape, dtype=dtype)
    n, h, w, _ = shape
    g = torch.from_numpy(rs.randn(n, h, d, w).astype(np.float32)).to(
        tdt).float().numpy()
    vjp = jax_vjp(lambda a, b: corr_cost_volume_pallas(a, b, d),
                  jnp.asarray(left), jnp.asarray(right))
    want = vjp(jnp.asarray(g))
    t = lambda a: torch.from_numpy(a).to(tdt)  # noqa: E731
    got = corr.corr_cost_volume_bwd(t(left), t(right), t(g), d, layout="hdw")
    for a, b in zip(got, want):
        assert a.dtype == tdt
        assert_grad_close(a, b)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,d", SHAPES[:2])
def test_corr_dlast_bwd_matches_xla_vjp(shape, d, dtype):
    tdt = DTYPES[dtype][0]
    left, right, rs = _inputs(shape, seed=1, dtype=dtype)
    n, h, w, _ = shape
    g = rs.randn(n, h, w, d).astype(np.float32)
    vjp = jax_vjp(lambda a, b: jdlast(a, b, d), jnp.asarray(left),
                  jnp.asarray(right))
    want = vjp(jnp.asarray(g))
    lt, rt = (torch.from_numpy(a).to(tdt).requires_grad_()
              for a in (left, right))
    out = corr.corr_cost_volume(lt, rt, d)  # autograd: the plain backward
    out.backward(torch.from_numpy(g))
    for a, b in zip((lt.grad, rt.grad), want):
        assert_grad_close(a, b)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,d", SHAPES)
def test_corr_softargmax_bwd_matches_jax(shape, d, dtype):
    """The fused epilogue's gradient against XLA's volume + soft-argmax
    (D <= W) or the Pallas VJP + soft-argmax over its D axis (D > W)."""
    tdt = DTYPES[dtype][0]
    left, right, rs = _inputs(shape, seed=2, dtype=dtype)
    n, h, w, _ = shape
    g = rs.randn(n, h, w).astype(np.float32)
    if d <= w:
        fn = lambda a, b: jsoftargmax(jdlast(a, b, d), axis=-1)  # noqa
    else:
        fn = lambda a, b: jsoftargmax(  # noqa: E731
            corr_cost_volume_pallas(a, b, d).astype(jnp.float32), axis=2)
    vjp = jax_vjp(fn, jnp.asarray(left), jnp.asarray(right))
    want = vjp(jnp.asarray(g))
    lt, rt = (torch.from_numpy(a).to(tdt).requires_grad_()
              for a in (left, right))
    corr.corr_softargmax(lt, rt, d).backward(torch.from_numpy(g))
    for a, b in zip((lt.grad, rt.grad), want):
        assert a.dtype == tdt
        assert_grad_close(a, b)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,d", SHAPES[:2])
def test_concat_bwd_matches_xla_vjp(shape, d, dtype):
    tdt = DTYPES[dtype][0]
    left, right, rs = _inputs(shape, seed=3, dtype=dtype)
    n, h, w, c = shape
    g = torch.from_numpy(rs.randn(n, d, h, w, 2 * c).astype(np.float32)).to(
        tdt).float().numpy()
    vjp = jax_vjp(lambda a, b: jcost_volume(a, b, d), jnp.asarray(left),
                  jnp.asarray(right))
    want = vjp(jnp.asarray(g))
    lt, rt = (torch.from_numpy(a).to(tdt).requires_grad_()
              for a in (left, right))
    concat.cost_volume_concat(lt, rt, d).backward(
        torch.from_numpy(g).to(tdt))
    for a, b in zip((lt.grad, rt.grad), want):
        assert a.dtype == tdt
        assert_grad_close(a, b)


def test_backwards_count_nothing_on_the_cpu():
    """The CPU route is the plain version: no backward launch counted."""
    before = (corr.corr_cost_volume_bwd.launches,
              corr.corr_softargmax_bwd.launches,
              concat.cost_volume_concat_bwd.launches)
    left, right, _ = _inputs((1, 2, 9, 4))
    lt, rt = (torch.from_numpy(a).requires_grad_() for a in (left, right))
    (corr.corr_cost_volume(lt, rt, 3).sum()
     + corr.corr_softargmax(lt, rt, 3).sum()
     + concat.cost_volume_concat(lt, rt, 3).sum()).backward()
    assert (corr.corr_cost_volume_bwd.launches,
            corr.corr_softargmax_bwd.launches,
            concat.cost_volume_concat_bwd.launches) == before


# ------------------------------------------------------- round-once convs

# (name, x shape NHWC / NDHWC, w shape HWIO / DHWIO, keywords) for the port
# and JAX functions of one name
CONVS = [
    ("conv2d", (2, 9, 11, 4), (3, 3, 4, 5), {"strides": (2, 2)}),
    ("conv2d", (1, 8, 10, 3), (5, 5, 3, 4), {"strides": (1, 1)}),
    ("conv3d", (1, 5, 6, 7, 4), (3, 3, 3, 4, 3), {"strides": (2, 2, 2)}),
    ("conv3d", (1, 4, 5, 6, 3), (3, 3, 3, 3, 4), {"strides": (1, 1, 1)}),
    ("conv2d_transpose", (2, 5, 6, 5), (3, 3, 4, 5),
     {"out_spatial": (9, 11), "strides": (2, 2)}),
    ("conv3d_transpose", (1, 3, 3, 4, 4), (3, 3, 3, 2, 4),
     {"out_spatial": (5, 6, 7), "strides": (2, 2, 2)}),
]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", range(len(CONVS)),
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CONVS)])
def test_round_once_conv_grads_match_jax(case, dtype):
    name, xs, ws, kw = CONVS[case]
    tdt, jdt = DTYPES[dtype]
    rs = np.random.RandomState(case)
    x = rs.randn(*xs).astype(np.float32)
    w = (rs.randn(*ws) / np.sqrt(np.prod(ws[:-1]))).astype(np.float32)
    b = rs.randn(ws[-2] if "transpose" in name else ws[-1]).astype(
        np.float32)
    jfn = getattr(jconv, name)
    out, vjp = jax.vjp(lambda a, k, c: jfn(a, k, c, **kw),
                       *(jnp.asarray(a, jdt) for a in (x, w, b)))
    g = rs.randn(*out.shape).astype(np.float32)
    want = vjp(jnp.asarray(g, jdt))
    xt, wt, bt = (torch.from_numpy(a).to(tdt).requires_grad_()
                  for a in (x, w, b))
    got = getattr(conv, name)(xt, wt, bt, **kw)
    assert got.dtype == tdt and tuple(got.shape) == out.shape
    assert_grad_close(got.detach(), out)
    got.backward(torch.from_numpy(g).to(tdt))
    for a, b_ in zip((xt.grad, wt.grad, bt.grad), want):
        assert a.dtype == tdt
        assert_grad_close(a, b_)


def test_round_once_conv2d_grads_match_autograd():
    """TrailNet's Caffe-padded `conv2d_round_once`: its `_ConvSum` gradients
    equal autograd's of the plain fp32 conv."""
    rs = np.random.RandomState(9)
    x, w, b = (torch.from_numpy(rs.randn(*s).astype(np.float32))
               for s in ((2, 4, 11, 13), (6, 4, 3, 3), (6,)))
    ref = [t.clone().requires_grad_() for t in (x, w, b)]
    torch.nn.functional.conv2d(*ref, 2, (1, 1)).square().sum().backward()
    mine = [t.clone().requires_grad_() for t in (x, w, b)]
    conv.conv2d_round_once(*mine, 2, (1, 1)).square().sum().backward()
    for a, b_ in zip(mine, ref):
        torch.testing.assert_close(a.grad, b_.grad, rtol=1e-5, atol=1e-5)
