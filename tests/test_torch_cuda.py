"""The port on the card: each CUDA kernel (corr volume, concat volume, fused
cost-volume assembly) against its plain version, the wrappers' no-fallback
rule, and small models served through the kernels.

Every test here needs an NVIDIA card and skips without one. The file
imports neither JAX nor `redtail_tpu`, so it also runs on a machine without
them, with the JAX-importing `tests/conftest.py` left out:

    python3 -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from redtail_tpu_torch.kernels import corr_cost_volume as corr
from redtail_tpu_torch.kernels import cost_volume_concat as concat
from redtail_tpu_torch.kernels import fused_cv_emit as emit
from redtail_tpu_torch.models import STEREO_SPECS, init_stereo_params
from redtail_tpu_torch.ops.convolution import plain_lowering
from redtail_tpu_torch.runtime import StereoNode

# (N, H, W, C), D: tests/test_kernels.py's pair, D == W, D > W, ragged W.
SHAPES = [((2, 14, 33, 8), 6), ((1, 3, 7, 4), 7), ((1, 3, 5, 4), 9),
          ((2, 7, 37, 8), 6)]
FLAGSHIP = ((1, 161, 513, 32), 48)
# NVSmall's and ResNet-18 3D's volume shapes (N, H, W, C), D.
NVSMALL, RESNET18_3D = ((1, 161, 513, 32), 48), ((1, 161, 513, 32), 68)
# Concat volume: ragged W, D > W, D == W, C not a multiple of 8, odd D.
CONCAT_SHAPES = [((2, 7, 37, 8), 6), ((1, 3, 5, 4), 9), ((1, 4, 6, 8), 6),
                 ((1, 4, 9, 3), 5), ((2, 5, 70, 5), 7)]
# Fused CV assembly, (N, H, W, K), D: ragged W, odd D, D > W, D == W, D = 1.
EMIT_SHAPES = [((2, 7, 37, 8), 6), ((1, 5, 70, 4), 7), ((1, 3, 5, 4), 9),
               ((1, 4, 6, 2), 6), ((1, 3, 9, 3), 1)]

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("native toolchain unavailable: needs an NVIDIA card "
                    "and nvcc (run on the card: python3 -m pytest "
                    "--noconftest -m cuda tests/test_torch_cuda.py)")
    return torch.device("cuda")


def _pair(device, shape, dtype=torch.float32, seed=0):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return tuple(torch.randn(shape, generator=gen, device=device).to(dtype)
                 for _ in range(2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["dlast", "hdw"])
@pytest.mark.parametrize("shape,d", SHAPES + [FLAGSHIP])
def test_kernel_matches_plain_on_card(cuda_device, shape, d, dtype, layout):
    left, right = _pair(cuda_device, shape, dtype)
    before = corr.corr_cost_volume.launches
    got = corr.corr_cost_volume(left, right, d, layout=layout)
    torch.cuda.synchronize()
    assert corr.corr_cost_volume.launches == before + 1
    want = corr.corr_cost_volume_plain(left, right, d, layout=layout)
    assert got.dtype == want.dtype and got.shape == want.shape
    # unit-scale inputs: fp32 summation order, then (bf16 out) one rounding
    tol = 1e-4 if got.dtype == torch.float32 else 2.0 ** -7 * (
        want.float().abs().max().item() + 1.0)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)


def test_cuda_tensors_never_take_plain_version(cuda_device, monkeypatch):
    def plain(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(corr, "corr_cost_volume_plain", plain)
    left, right = _pair(cuda_device, (1, 4, 40, 8))
    assert corr.corr_cost_volume(left, right, 5).is_cuda


@pytest.mark.parametrize("bad", ["strided", "device"])
def test_wrapper_raises_on_bad_cuda_input(cuda_device, bad):
    left, right = _pair(cuda_device, (1, 4, 40, 8))
    if bad == "strided":
        left, right = left[:, :, ::2], right[:, :, ::2]
    else:
        right = right.cpu()
    before = corr.corr_cost_volume.launches
    with pytest.raises(ValueError):
        corr.corr_cost_volume(left, right, 5)
    assert corr.corr_cost_volume.launches == before


def test_stereo_node_serves_through_the_kernel(cuda_device):
    hw = (65, 129)
    spec = dataclasses.replace(STEREO_SPECS["resnet18_2d"], input_hw=hw,
                               max_disp=8)
    node = StereoNode(spec, init_stereo_params(spec, seed=0),
                      dtype=torch.bfloat16)
    rs = np.random.RandomState(0)
    left, right = (rs.randint(0, 256, hw + (3,)).astype(np.uint8)
                   for _ in range(2))
    before = corr.corr_cost_volume.launches
    disp = node(left, right)
    assert corr.corr_cost_volume.launches == before + 1
    assert disp.shape == hw and disp.dtype == np.float32
    assert np.isfinite(disp).all() and 0 <= disp.min() <= disp.max() <= hw[1]


def _ulp_ok(got, want, atol):
    """Within one bf16 ulp of the larger magnitude plus ``atol``."""
    mag = torch.maximum(got.float().abs(), want.float().abs())
    ulp = torch.exp2(torch.floor(torch.log2(mag.clamp_min(2.0 ** -126))) - 7)
    return bool(((got.float() - want.float()).abs() <= ulp + atol).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,d", CONCAT_SHAPES + [NVSMALL, RESNET18_3D])
def test_concat_kernel_bit_exact_on_card(cuda_device, shape, d, dtype):
    left, right = _pair(cuda_device, shape, dtype)
    before = concat.cost_volume_concat.launches
    got = concat.cost_volume_concat(left, right, d)
    torch.cuda.synchronize()
    assert concat.cost_volume_concat.launches == before + 1
    # a pure copy: bit for bit
    assert torch.equal(got, concat.cost_volume_concat_plain(left, right, d))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,d", EMIT_SHAPES + [NVSMALL, RESNET18_3D])
def test_emit_kernel_matches_plain_on_card(cuda_device, shape, d, dtype):
    n, h, w, k = shape
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(1)
    la, rb, bias = (torch.randn(s, generator=gen, device=cuda_device)
                    for s in ((n, h, w, 3 * k), (n, h, w, 6 * k), (k,)))
    la, rb = la.to(dtype), rb.to(dtype)
    before = emit.fused_cv_emit.launches
    got = emit.fused_cv_emit(la, rb, bias, d)
    torch.cuda.synchronize()
    assert emit.fused_cv_emit.launches == before + 1
    want = emit.fused_cv_emit_plain(la, rb, bias, d)
    assert got.dtype == want.dtype and got.shape == want.shape
    # unit-scale maps: fp32 summation order, then (bf16) one rounding
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    else:
        assert _ulp_ok(got, want, 1e-4)


def test_new_kernels_never_take_plain_version(cuda_device, monkeypatch):
    def plain(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(concat, "cost_volume_concat_plain", plain)
    monkeypatch.setattr(emit, "fused_cv_emit_plain", plain)
    left, right = _pair(cuda_device, (1, 4, 40, 8))
    assert concat.cost_volume_concat(left, right, 5).is_cuda
    la, rb = _pair(cuda_device, (1, 4, 40, 6))
    assert emit.fused_cv_emit(la, torch.cat([rb, rb], -1), None, 5).is_cuda


def test_new_kernels_raise_on_strided_input(cuda_device):
    left, right = _pair(cuda_device, (1, 4, 40, 8))
    with pytest.raises(ValueError):
        concat.cost_volume_concat(left[:, :, ::2], right[:, :, ::2], 5)
    la, rb = _pair(cuda_device, (1, 4, 40, 12))
    with pytest.raises(ValueError):
        emit.fused_cv_emit(la[..., ::2], rb, None, 5)


@pytest.mark.parametrize("lowering", ["fused", "plain"])
def test_stereo_node_3d_serves_through_the_kernels(cuda_device, lowering):
    hw = (65, 129)
    spec = dataclasses.replace(STEREO_SPECS["nvtiny"], input_hw=hw,
                               max_disp=8)
    node = StereoNode(spec, init_stereo_params(spec, seed=0),
                      dtype=torch.bfloat16)
    rs = np.random.RandomState(0)
    left, right = (rs.randint(0, 256, hw + (3,)).astype(np.uint8)
                   for _ in range(2))
    counter = (emit.fused_cv_emit if lowering == "fused"
               else concat.cost_volume_concat)
    before = counter.launches
    if lowering == "plain":
        with plain_lowering():
            disp = node(left, right)
    else:
        disp = node(left, right)
    assert counter.launches == before + 1
    assert disp.shape == hw and disp.dtype == np.float32
    assert np.isfinite(disp).all()
    assert 0 <= disp.min() <= disp.max() <= spec.full_max_disp
