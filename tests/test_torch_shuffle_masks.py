"""The port's sub-pixel transposed convs and the packed head's mask forms
against the JAX package's, on the CPU.

- `conv2d_transpose_shuffle` / `conv3d_transpose_shuffle` against JAX's
  twins and against the port's dilated (cuDNN) form, at odd and even
  output sizes (both TF-SAME low-pad parities) and c_out 1 (the models'
  last deconvs) and 3, fp32, within 1e-5; the ``impl=`` argument of
  `conv2d_transpose` / `conv3d_transpose` (``None`` the dilated form).
- `ops.packed3d.mask_form`: every packed op under ``'mul'`` equals itself
  under ``'where'`` value for value (``torch.equal``: -0.0 == 0.0) and
  JAX's op under the same form within 1e-5; the packed head under
  ``REDTAIL_TPU_MASK_FORM`` and ``REDTAIL_TPU_MASK_MUL`` (set for both
  packages) against JAX's within the packed head's 1e-3 px.
Seeded numpy inputs, random nonzero biases.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from redtail_tpu.models import STEREO_SPECS as JSPECS
from redtail_tpu.models import stereo as jstereo
from redtail_tpu.ops import convolution as JC
from redtail_tpu.ops import packed3d as J

from redtail_tpu_torch.models import (STEREO_SPECS, init_stereo_params,
                                      params_from_numpy)
from redtail_tpu_torch.ops import convolution as C
from redtail_tpu_torch.ops import packed3d as P
from redtail_tpu_torch.ops.convolution import packed3d_lowering
from test_torch_stereo import _inputs, conditioned

ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, 2))
    yield
    torch.set_num_threads(saved)


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in ("REDTAIL_TPU_PACKED3D", "REDTAIL_TPU_DFOLD",
                "REDTAIL_TPU_PALLAS_CONV3D", "REDTAIL_TPU_MASK_FORM",
                "REDTAIL_TPU_MASK_MUL"):
        monkeypatch.delenv(var, raising=False)


def _rand(shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _np(x):
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("out_hw", [(10, 14), (9, 13), (10, 13)], ids=str)
@pytest.mark.parametrize("c_out", [1, 3])
def test_conv2d_transpose_shuffle_matches_jax(out_hw, c_out):
    y = _rand((2, -(-out_hw[0] // 2), -(-out_hw[1] // 2), 5))
    w = _rand((3, 3, c_out, 5), 1, 0.3)
    b = _rand((c_out,), 2)
    want = _np(JC.conv2d_transpose_shuffle(jnp.asarray(y), jnp.asarray(w),
                                           jnp.asarray(b),
                                           out_spatial=out_hw))
    got = C.conv2d_transpose_shuffle(_t(y), _t(w), _t(b), out_spatial=out_hw)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    dilated = C.conv2d_transpose(_t(y), _t(w), _t(b), out_spatial=out_hw)
    np.testing.assert_allclose(got.numpy(), dilated.numpy(), atol=ATOL)
    assert torch.equal(C.conv2d_transpose(_t(y), _t(w), _t(b),
                                          out_spatial=out_hw,
                                          impl="shuffle"), got)


@pytest.mark.parametrize("out_dhw", [(8, 10, 12), (7, 9, 11), (6, 9, 13)],
                         ids=str)
@pytest.mark.parametrize("c_out", [1, 3])
def test_conv3d_transpose_shuffle_matches_jax(out_dhw, c_out):
    y = _rand((1, *(-(-v // 2) for v in out_dhw), 4))
    w = _rand((3, 3, 3, c_out, 4), 1, 0.3)
    b = _rand((c_out,), 2)
    want = _np(JC.conv3d_transpose_shuffle(jnp.asarray(y), jnp.asarray(w),
                                           jnp.asarray(b),
                                           out_spatial=out_dhw))
    got = C.conv3d_transpose_shuffle(_t(y), _t(w), _t(b),
                                     out_spatial=out_dhw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    for impl in (None, "dilated", "shuffle", "dfold"):
        other = C.conv3d_transpose(_t(y), _t(w), _t(b), out_spatial=out_dhw,
                                   impl=impl)
        np.testing.assert_allclose(other.numpy(), want, atol=ATOL,
                                   err_msg=str(impl))


def test_shuffle_transpose_bf16_rounds_once():
    """bf16: the fp32 sum, bias and one rounding, as JAX's bf16 shuffle."""
    out_hw = (9, 14)
    y = _rand((1, 5, 7, 8))
    w = _rand((3, 3, 1, 8), 1, 0.3)
    b = _rand((1,), 2)
    to = lambda a: jnp.asarray(a, jnp.bfloat16)   # noqa: E731
    want = _np(JC.conv2d_transpose_shuffle(to(y), to(w), to(b),
                                           out_spatial=out_hw))
    got = C.conv2d_transpose_shuffle(_t(y).bfloat16(), _t(w).bfloat16(),
                                     _t(b).bfloat16(), out_spatial=out_hw)
    assert got.dtype == torch.bfloat16
    # both round one fp32 sum of exact products: at most one bf16 step
    mag = np.maximum(np.abs(want), 1e-3)
    assert (np.abs(got.float().numpy() - want) <= mag * 2 ** -7).all()


def test_transpose_impl_refusals():
    y, w = torch.zeros(1, 3, 3, 2), torch.zeros(3, 3, 1, 2)
    with pytest.raises(ValueError, match="impl"):
        C.conv2d_transpose(y, w, out_spatial=(6, 6), impl="dfold")
    with pytest.raises(ValueError, match="k=3 stride-2"):
        C.conv2d_transpose(y, torch.zeros(5, 5, 1, 2), out_spatial=(6, 6),
                           impl="shuffle")


# ------------------------------------------------------------ mask forms


def _packed_ops(dhw, packed_h):
    """(name, port call, JAX call) of each packed op with masks, on seeded
    inputs for ``dhw``."""
    x = _rand((1, *dhw, 4))
    w = _rand((3, 3, 3, 4, 5), 1, 0.2)
    b = _rand((5,), 2)
    ops = []
    for shifted in (False, True):
        xp = _np(J.pack(jnp.asarray(x), d=True, h=packed_h, shifted=shifted))
        ops.append((f"conv in_shifted={shifted}",
                    lambda xp=xp, s=shifted: P.conv3d_packed(
                        _t(xp), _t(w), _t(b), full_spatial=dhw,
                        packed_h=packed_h, in_shifted=s),
                    lambda xp=xp, s=shifted: J.conv3d_packed(
                        jnp.asarray(xp), w, b, full_spatial=dhw,
                        packed_h=packed_h, in_shifted=s)))
    xa = _np(J.pack(jnp.asarray(x), d=True, h=packed_h))
    ops.append(("down", lambda: P.conv3d_packed_down(
        _t(xa), _t(w), _t(b), full_spatial=dhw, packed_h=packed_h),
        lambda: J.conv3d_packed_down(jnp.asarray(xa), w, b,
                                     full_spatial=dhw, packed_h=packed_h)))
    y = _rand((1, *(-(-v // 2) for v in dhw), 5), 3)
    wt = _rand((3, 3, 3, 4, 5), 4, 0.2)
    bt = _rand((4,), 5)
    ops.append(("deconv", lambda: P.deconv3d_packed(
        _t(y), _t(wt), _t(bt), out_spatial=dhw, in_packed_d=False,
        pack_h=packed_h),
        lambda: J.deconv3d_packed(jnp.asarray(y), wt, bt, out_spatial=dhw,
                                  in_packed_d=False, pack_h=packed_h)))
    return ops


@pytest.mark.parametrize("dhw", [(8, 10, 12), (7, 9, 11)], ids=str)
@pytest.mark.parametrize("packed_h", [True, False])
def test_mask_forms_are_one_function(dhw, packed_h):
    for name, port, jax_op in _packed_ops(dhw, packed_h):
        outs = {}
        for form in P.MASK_FORMS:
            with P.mask_form(form):
                outs[form] = port()
            with J.mask_form(form):
                want = _np(jax_op())
            np.testing.assert_allclose(outs[form].numpy(), want, atol=ATOL,
                                       err_msg=f"{name} {form}")
        assert torch.equal(outs["mul"], outs["where"]), name
        assert torch.equal(outs["auto"], outs["where"]), name


def test_mask_form_refuses_unknown_forms():
    with pytest.raises(ValueError, match="mask form"):
        with P.mask_form("select"):
            pass


@pytest.mark.parametrize("env", [
    {"REDTAIL_TPU_MASK_FORM": "mul"},
    {"REDTAIL_TPU_MASK_FORM": "where"},
    {"REDTAIL_TPU_MASK_MUL": "conv3D_2,conv3D_4,deconv3D_1"},
], ids=["mul", "where", "mul-per-layer"])
def test_packed_head_mask_forms_match_jax(monkeypatch, env):
    hw = (34, 66)
    spec = dataclasses.replace(STEREO_SPECS["nvsmall"], input_hw=hw,
                               max_disp=8)
    jspec = dataclasses.replace(JSPECS["nvsmall"], input_hw=hw, max_disp=8)
    params = conditioned(init_stereo_params(spec, seed=0))
    left, right = _inputs(hw, s2d=True)
    net = params_from_numpy(spec, params, device="cpu")
    with packed3d_lowering():
        auto = net(torch.from_numpy(left), torch.from_numpy(right))
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    monkeypatch.setenv("REDTAIL_TPU_PACKED3D", "1")
    want = np.asarray(jstereo.stereo_forward(
        jspec, jax.tree.map(jnp.asarray, params), jnp.asarray(left),
        jnp.asarray(right)), np.float32)
    seen = []
    real = P._mask_slot

    def spy(y, axis, slot, ranges, auto="where"):
        seen.append(P._MASK_FORM.get())
        return real(y, axis, slot, ranges, auto)
    monkeypatch.setattr(P, "_mask_slot", spy)
    got = net(torch.from_numpy(left), torch.from_numpy(right))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)
    assert torch.equal(got, auto)      # every form, one function
    forms = set(seen)
    if "REDTAIL_TPU_MASK_FORM" in env:
        assert forms == {env["REDTAIL_TPU_MASK_FORM"]}
    else:
        assert forms == {"mul", "auto"}
