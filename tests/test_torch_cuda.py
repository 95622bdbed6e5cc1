"""The port on the card: each CUDA kernel (corr volume in its three
epilogues, concat volume, fused cost-volume assembly in both layouts, the
packed head's dense conv223, the 3D encoder's conv + ELU, the 3D decoder's
transposed conv + skip + ELU) against its
plain version, the wrappers' no-fallback rule and their refusal of
autograd, small models served through the kernels, and TrailNet and the
YOLO node (no kernel on their path) against the CPU, the serving runtime:
frames in flight on the nodes' streams, microbatches through the kernels,
the u16 wire; and the quantized rungs: the exact int8 conv and
`quantize_act` bit-equal to the CPU, the round-once bf16 convs, quantized
nodes through the corr kernel, a TRT blob's net bit-equal to its tree.

Every test here needs an NVIDIA card and skips without one. The file
imports neither JAX nor `redtail_tpu`, so it also runs on a machine without
them, with the JAX-importing `tests/conftest.py` left out:

    python3 -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import contextlib
import dataclasses
import hashlib
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from redtail_tpu_torch.kernels import conv223 as c223
from redtail_tpu_torch.kernels import conv3d_k3 as k3
from redtail_tpu_torch.kernels import corr_cost_volume as corr
from redtail_tpu_torch.kernels import cost_volume_concat as concat
from redtail_tpu_torch.kernels import deconv3d_s2 as d2
from redtail_tpu_torch.kernels import fused_cv_emit as emit
from redtail_tpu_torch.io import parse_prototxt
from redtail_tpu_torch.models import (
    STEREO_SPECS,
    CaffeNet,
    emit_trailnet_prototxt,
    init_stereo_params,
    native_params_to_blobs,
    params_from_numpy,
    params_from_w8_npz,
    yolo,
)
from redtail_tpu_torch.models import trailnet
from redtail_tpu_torch.ops import convolution as conv_ops
from redtail_tpu_torch.ops.convolution import packed3d_lowering, plain_lowering
from redtail_tpu_torch.runtime import StereoNode, TrailNetNode, YoloNode

TRAILNET_W8 = Path(__file__).resolve().parent / "data" / \
    "trailnet_synth_trained.npz"

# (N, H, W, C), D: tests/test_kernels.py's pair, D == W, D > W, ragged W.
SHAPES = [((2, 14, 33, 8), 6), ((1, 3, 7, 4), 7), ((1, 3, 5, 4), 9),
          ((2, 7, 37, 8), 6)]
FLAGSHIP = ((1, 161, 513, 32), 48)
# The corr kernel's edges (16-column warps, chunks of 64 disparities,
# 32-channel bf16 steps): W = 63, 64, 65 and 513 at D = 1, 47, 48, 49;
# D > W with batch 2; C = 8; two channel steps (C = 40 bf16); C = 3
# (loaded element by element); three disparity chunks.
CORR_EDGES = [((1, 3, 63, 32), 47), ((1, 3, 64, 32), 48), ((1, 3, 65, 32), 49),
              ((1, 2, 513, 32), 1), ((2, 3, 65, 8), 48), ((2, 2, 20, 8), 33),
              ((1, 2, 33, 40), 9), ((1, 2, 9, 3), 5), ((1, 2, 70, 16), 130)]
# NVSmall's and ResNet-18 3D's volume shapes (N, H, W, C), D.
NVSMALL, RESNET18_3D = ((1, 161, 513, 32), 48), ((1, 161, 513, 32), 68)
# Concat volume: ragged W, D > W, D == W, C not a multiple of 8, odd D.
CONCAT_SHAPES = [((2, 7, 37, 8), 6), ((1, 3, 5, 4), 9), ((1, 4, 6, 8), 6),
                 ((1, 4, 9, 3), 5), ((2, 5, 70, 5), 7)]
# Fused CV assembly, (N, H, W, K), D: ragged W, odd D, D > W, D == W, D = 1;
# the kernel's K = 64 instantiation at the main path's D, K not a multiple
# of 8 with odd D, batch 2 with odd D, D >= W at K = 32 with batch 2.
EMIT_SHAPES = [((2, 7, 37, 8), 6), ((1, 5, 70, 4), 7), ((1, 3, 5, 4), 9),
               ((1, 4, 6, 2), 6), ((1, 3, 9, 3), 1), ((1, 9, 513, 64), 48),
               ((1, 5, 33, 12), 7), ((2, 6, 70, 64), 11),
               ((2, 5, 40, 32), 48)]
# conv223 xp (N, Dp, Hp, W, C), K: NVSmall's conv3D_2, ResNet-18 3D's
# conv3D_1b, NVTiny's conv3D_2; batch 2, odd Hp and Dp, W < 8, C = K = 16,
# K != C, a ragged last column tile; the bf16 kernel's 4 x 64 tiles: W at
# 63, 64, 65 and 257, Hout not a multiple of 4, K = 16, 32, 64, 128 with
# C != K, batch 2 at K = 128, and 280 tiles (more than 2 x 132 SMs: the
# persistent loop wraps).
CONV223_MODELS = [((1, 25, 82, 513, 128), 128), ((1, 35, 82, 513, 128), 128),
                  ((1, 13, 42, 257, 64), 64)]
CONV223_EDGES = [((2, 4, 6, 20, 32), 32), ((1, 5, 7, 9, 16), 16),
                 ((1, 3, 4, 5, 16), 16), ((2, 3, 5, 70, 48), 32),
                 ((1, 2, 3, 65, 64), 144), ((1, 3, 6, 63, 32), 16),
                 ((1, 3, 6, 64, 64), 32), ((1, 3, 6, 65, 16), 64),
                 ((1, 3, 7, 257, 32), 128), ((2, 3, 9, 130, 64), 128),
                 ((1, 9, 42, 200, 32), 16)]

# conv3d_k3 x (N, D, H, W, C), K: NVSmall's conv3D_2, conv3D_4, conv3D_7 and
# ResNet-18 3D's conv3D_1b, conv3D_5a; then the edges: N = 4, D = 1 and 2,
# W = 33, 63, 64, 65, 257, 513, H not a multiple of the tile's 4 rows (and
# H = 1), every C and K in 16..128.
K3_MODELS = [((1, 48, 161, 513, 32), 32), ((1, 24, 81, 257, 64), 64),
             ((1, 12, 41, 129, 128), 128), ((1, 68, 161, 513, 32), 32),
             ((1, 5, 11, 33, 128), 128)]
K3_EDGES = [((4, 2, 7, 65, 16), 16), ((1, 1, 6, 63, 32), 64),
            ((4, 2, 5, 64, 64), 32), ((1, 2, 9, 65, 128), 16),
            ((1, 24, 10, 33, 16), 128), ((2, 3, 13, 257, 64), 128),
            ((1, 2, 3, 513, 128), 64), ((1, 1, 1, 33, 32), 32),
            ((4, 1, 6, 257, 32), 16)]
# conv223 at phase 3's bf16 calls (NVSmall's conv3D_2, ResNet-18 3D's
# conv3D_1b; inputs from the CPU generator, `_conv223_pinned_inputs`): the
# SHA-256 of the output bytes the kernel gave before it shared its pipeline
# with conv3d_k3 (the same kernel, on an NVIDIA H100 80GB HBM3).
CONV223_PINNED = {
    ((1, 25, 82, 513, 128), 128):
        "50b39fab4f44e8e2adecc848cf861c4e5b933c6c093f36ba36805fbb0ea151c9",
    ((1, 35, 82, 513, 128), 128):
        "08f354c43599eed22aee3743b6b8ead6cb9eeb66ee1617153b08c06d1af17563"}

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
@pytest.mark.parametrize("shape,d", SHAPES + CORR_EDGES + [FLAGSHIP])
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,d", SHAPES + CORR_EDGES + [FLAGSHIP])
def test_softargmax_kernel_matches_plain_on_card(cuda_device, shape, d,
                                                 dtype):
    left, right = _pair(cuda_device, shape, dtype, seed=1)
    # scaled by 1/sqrt(C): the volume is O(1), as trained features make it
    left, right = (t * shape[-1] ** -0.5 for t in (left, right))
    before = (corr.corr_softargmax.launches, corr.corr_cost_volume.launches)
    got = corr.corr_softargmax(left, right, d)
    torch.cuda.synchronize()
    assert (corr.corr_softargmax.launches,
            corr.corr_cost_volume.launches) == (before[0] + 1, before[1])
    want = corr.corr_softargmax_plain(left, right, d)
    assert got.dtype == want.dtype == torch.float32
    assert got.shape == want.shape == shape[:3]
    # index units: the volume's fp32 summation order through the softmax
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def test_cuda_tensors_never_take_plain_version(cuda_device, monkeypatch):
    def plain(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(corr, "corr_cost_volume_plain", plain)
    left, right = _pair(cuda_device, (1, 4, 40, 8))
    assert corr.corr_cost_volume(left, right, 5).is_cuda


def test_fused_cuda_tensors_never_take_plain_version(cuda_device,
                                                     monkeypatch):
    def plain(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(corr, "corr_softargmax_plain", plain)
    monkeypatch.setattr(corr, "corr_cost_volume_plain", plain)
    left, right = _pair(cuda_device, (1, 4, 40, 8))
    assert corr.corr_softargmax(left, right, 5).is_cuda


@pytest.mark.parametrize("bad", ["strided", "device"])
def test_wrapper_raises_on_bad_cuda_input(cuda_device, bad):
    left, right = _pair(cuda_device, (1, 4, 40, 8))
    if bad == "strided":
        left, right = left[:, :, ::2], right[:, :, ::2]
    else:
        right = right.cpu()
    before = (corr.corr_cost_volume.launches, corr.corr_softargmax.launches)
    with pytest.raises(ValueError):
        corr.corr_cost_volume(left, right, 5)
    with pytest.raises(ValueError):
        corr.corr_softargmax(left, right, 5)
    assert (corr.corr_cost_volume.launches,
            corr.corr_softargmax.launches) == before


def test_stereo_node_serves_through_the_kernel(cuda_device):
    """The fused epilogue once a frame; the volume never reaches device
    memory."""
    hw = (65, 129)
    spec = dataclasses.replace(STEREO_SPECS["resnet18_2d"], input_hw=hw,
                               max_disp=8)
    node = StereoNode(spec, init_stereo_params(spec, seed=0),
                      dtype=torch.bfloat16)
    rs = np.random.RandomState(0)
    left, right = (rs.randint(0, 256, hw + (3,)).astype(np.uint8)
                   for _ in range(2))
    before = (corr.corr_softargmax.launches, corr.corr_cost_volume.launches)
    disp = node(left, right)
    assert (corr.corr_softargmax.launches,
            corr.corr_cost_volume.launches) == (before[0] + 1, before[1])
    assert disp.shape == hw and disp.dtype == np.float32
    assert np.isfinite(disp).all() and 0 <= disp.min() <= disp.max() <= hw[1]


# The grouped soft-argmax (N, Hp, W, 2 C), D, original rows, channel
# slices: the JAX package's H-packed head at ResNet18-2D's 321x1025 (161
# rows: a pad row, the towers' map halves; no model path of the port
# launches it), even rows, odd rows at batch 2, the warp and chunk edges,
# C = 3.
GROUPED = [((1, 81, 513, 64), 48, 161, True), ((1, 8, 65, 64), 48, 16, False),
           ((2, 5, 37, 16), 9, 9, True), ((1, 3, 63, 64), 47, 5, True),
           ((1, 3, 65, 64), 49, 6, False), ((1, 2, 513, 64), 1, 3, True),
           ((1, 3, 9, 6), 5, 5, False)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,d,rows,slices", GROUPED)
def test_grouped_softargmax_kernel_matches_plain_on_card(
        cuda_device, shape, d, rows, slices, dtype):
    n, hp, w, gc = shape
    if slices:   # each half of one wider map, as the H-packed head reads
        both = _pair(cuda_device, (n, hp, w, 2 * gc), dtype, seed=2)[0]
        left, right = both[..., :gc], both[..., gc:]
    else:
        left, right = _pair(cuda_device, shape, dtype, seed=2)
    scale = (gc // 2) ** -0.5
    left, right = left * scale, right * scale
    if slices:
        both = torch.cat([left, right], dim=-1)
        left, right = both[..., :gc], both[..., gc:]
    before = (corr.corr_softargmax.launches,
              corr.corr_softargmax.grouped_launches)
    got = corr.corr_softargmax(left, right, d, groups=2, rows=rows)
    torch.cuda.synchronize()
    assert (corr.corr_softargmax.launches,
            corr.corr_softargmax.grouped_launches) == (before[0] + 1,
                                                       before[1] + 1)
    want = corr.corr_softargmax_plain(left, right, d, 2, rows)
    assert got.shape == want.shape == (n, hp, w, 2)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    # each group is, bit for bit, the ungrouped launch on its rows
    c = gc // 2
    for g in (0, 1):
        one = corr.corr_softargmax(left[..., g * c:(g + 1) * c].contiguous(),
                                   right[..., g * c:(g + 1) * c].contiguous(),
                                   d)
        real = [i for i in range(hp) if 2 * i + g < rows]
        assert torch.equal(got[:, real, :, g], one[:, real])
        assert (got[:, [i for i in range(hp) if 2 * i + g >= rows], :, g]
                == 0).all()


def test_grouped_softargmax_refuses_autograd_on_card(cuda_device):
    left, right = _pair(cuda_device, (1, 3, 20, 16))
    left.requires_grad_(True)
    before = corr.corr_softargmax.launches
    with pytest.raises(RuntimeError, match="no backward"):
        corr.corr_softargmax(left, right, 5, groups=2, rows=6)
    assert corr.corr_softargmax.launches == before


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


def _conv223_inputs(device, xshape, k_out, dtype, seed=2):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    c = xshape[-1]
    xp = torch.randn(xshape, generator=gen, device=device).to(dtype)
    # He-scaled: outputs O(1), as the head's are
    k = (torch.randn((2, 2, 3, c, k_out), generator=gen, device=device)
         * (12 * c) ** -0.5).to(dtype)
    bias = torch.randn(k_out, generator=gen, device=device)
    return xp, k, bias


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("xshape,k_out", CONV223_EDGES + CONV223_MODELS,
                         ids=str)
def test_conv223_kernel_matches_plain_on_card(cuda_device, xshape, k_out,
                                              dtype):
    xp, k, bias = _conv223_inputs(cuda_device, xshape, k_out, dtype)
    before = c223.conv223.launches
    got = c223.conv223(xp, k, bias)
    torch.cuda.synchronize()
    assert c223.conv223.launches == before + 1
    want = c223.conv223_plain(xp, k, bias)
    assert got.dtype == want.dtype and got.shape == want.shape
    # O(1) outputs: fp32 summation order, then (bf16) one rounding
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    else:
        assert _ulp_ok(got, want, 1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("xshape,k_out", [((1, 3, 7, 257, 32), 128),
                                          ((1, 25, 82, 513, 128), 128)],
                         ids=str)
def test_conv223_kernel_form_matches_contract_form_on_card(
        cuda_device, xshape, k_out, dtype):
    """The packed head hands the kernel its weights in the K-major form
    (`kernel_weights`, at load): the same result as the (2, 2, 3, C, K)
    form, bit for bit, one launch each."""
    xp, k, bias = _conv223_inputs(cuda_device, xshape, k_out, dtype)
    before = c223.conv223.launches
    got = c223.conv223(xp, c223.kernel_weights(k), bias, "kc")
    want = c223.conv223(xp, k, bias)
    torch.cuda.synchronize()
    assert c223.conv223.launches == before + 2
    assert torch.equal(got, want)


def _k3_inputs(device, xshape, k_out, seed=3):
    """x, the kernel-form weights (He-scaled: O(1) outputs, about half
    through the ELU's negative branch) and an fp32 bias."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    c = xshape[-1]
    x = torch.randn(xshape, generator=gen, device=device).bfloat16()
    w = torch.randn((k_out, c, 3, 3, 3), generator=gen, device=device) \
        * (27 * c) ** -0.5
    bias = torch.randn(k_out, generator=gen, device=device) * 0.3
    return x, k3.kernel_weights(w), bias


@pytest.mark.parametrize("xshape,k_out", K3_EDGES + K3_MODELS, ids=str)
def test_conv3d_k3_kernel_matches_plain_on_card(cuda_device, xshape, k_out):
    """Every element, after the ELU, within one bf16 step of the plain
    version (the round-once conv on fp32 carriers and the bf16 ELU;
    `chip_smoke.k3_step_ok`): the fp32 sums differ in order only."""
    x, kt, bias = _k3_inputs(cuda_device, xshape, k_out)
    before = k3.conv3d_k3.launches
    got = k3.conv3d_k3(x, kt, bias)
    torch.cuda.synchronize()
    assert k3.conv3d_k3.launches == before + 1
    want = k3.conv3d_k3_plain(x, kt, bias)
    assert got.dtype == want.dtype == torch.bfloat16
    assert got.shape == want.shape == (*xshape[:4], k_out)
    assert chip_smoke.k3_step_ok(torch, k3, got, x, kt, bias)
    assert (want < 0).float().mean() > 0.2
    # a fault in the tiling (a tap, a pad, a tile's edge) moves most of the
    # outputs it touches; the order of summation moves a few by one step
    assert (got != want).float().mean() < 0.05


@pytest.mark.parametrize("c", k3.CHANNELS)
@pytest.mark.parametrize("k_out", k3.CHANNELS)
def test_conv3d_k3_every_width_on_card(cuda_device, c, k_out):
    x, kt, bias = _k3_inputs(cuda_device, (2, 3, 6, 70, c), k_out, seed=c)
    assert chip_smoke.k3_step_ok(torch, k3, k3.conv3d_k3(x, kt, bias), x, kt,
                                 bias)


def test_conv3d_k3_repeats_bit_for_bit_on_card(cuda_device):
    x, kt, bias = _k3_inputs(cuda_device, (1, 48, 161, 513, 32), 32)
    first = k3.conv3d_k3(x, kt, bias)
    assert torch.equal(k3.conv3d_k3(x, kt, bias), first)


def _d2_inputs(device, yshape, c_out, out, seed=3):
    """y, the kernel-form weights (scaled: O(1) outputs, about half
    through the ELU's negative branch), an fp32 bias and a bf16 skip (None
    where c_out = 1)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    c = yshape[-1]
    y = torch.randn(yshape, generator=gen, device=device).bfloat16()
    w = torch.randn((c, c_out, 3, 3, 3), generator=gen, device=device) \
        * (8 * c) ** -0.5
    bias = torch.randn(c_out, generator=gen, device=device) * 0.3
    skip = None if c_out == 1 else (0.5 * torch.randn(
        (yshape[0], *out, c_out), generator=gen, device=device)).bfloat16()
    return y, d2.kernel_weights(w), bias, skip


@pytest.mark.parametrize("name,yshape,c_out,out", chip_smoke.D2_CASES,
                         ids=[case[0] for case in chip_smoke.D2_CASES])
def test_deconv3d_s2_kernel_matches_plain_on_card(cuda_device, name, yshape,
                                                  c_out, out):
    """Every element within one bf16 step of the plain version (the
    round-once transposed conv on fp32 carriers, the bf16 skip add and
    ELU), that step carried through the skip add and the ELU
    (`chip_smoke.d2_step_ok`): the fp32 sums differ in order only."""
    y, kt, bias, skip = _d2_inputs(cuda_device, yshape, c_out, out)
    before = d2.deconv3d_s2.launches
    got = d2.deconv3d_s2(y, kt, bias, skip, out)
    torch.cuda.synchronize()
    assert d2.deconv3d_s2.launches == before + 1
    want = d2.deconv3d_s2_plain(y, kt, bias, skip, out)
    assert got.dtype == want.dtype == torch.bfloat16
    assert got.shape == want.shape == (yshape[0], *out, c_out)
    assert chip_smoke.d2_step_ok(torch, d2, got, y, kt, bias, skip, out)
    if skip is not None:
        assert (want < 0).float().mean() > 0.2
    # a fault in the tiling (a tap, a class's voxel, a pad, a tile's edge)
    # moves most of the outputs it touches; the order of summation moves a
    # few by one step
    assert (got != want).float().mean() < 0.05


@pytest.mark.parametrize("c", d2.CHANNELS)
@pytest.mark.parametrize("c_out", d2.OUT_CHANNELS)
def test_deconv3d_s2_every_width_on_card(cuda_device, c, c_out):
    out = (5, 12, 139)
    y, kt, bias, skip = _d2_inputs(cuda_device, (2, 3, 6, 70, c), c_out, out,
                                   seed=c + c_out)
    assert chip_smoke.d2_step_ok(torch, d2, d2.deconv3d_s2(
        y, kt, bias, skip, out), y, kt, bias, skip, out)


@pytest.mark.parametrize("case", [0, 1, 2, 6, 7], ids=lambda i:
                         chip_smoke.D2_CASES[i][0])
def test_deconv3d_s2_repeats_bit_for_bit_on_card(cuda_device, case):
    _, yshape, c_out, out = chip_smoke.D2_CASES[case]
    y, kt, bias, skip = _d2_inputs(cuda_device, yshape, c_out, out)
    first = d2.deconv3d_s2(y, kt, bias, skip, out)
    assert torch.equal(d2.deconv3d_s2(y, kt, bias, skip, out), first)


def test_decoder_runs_the_deconv3d_s2_kernel_on_card(cuda_device):
    """A bf16 NVSmall forward launches the kernel once a decoder layer,
    within bf16 noise of the same forward on the cuDNN route; an fp32 net,
    the packed head, a forward that needs grad and a layer under
    `sharded_axis` launch it never."""
    hw = (65, 129)
    spec = dataclasses.replace(STEREO_SPECS["nvsmall"], input_hw=hw,
                               max_disp=16)
    params = init_stereo_params(spec, seed=0)
    net = params_from_numpy(spec, params, device=cuda_device,
                            dtype=torch.bfloat16)
    rs = np.random.RandomState(1)
    left, right = (torch.from_numpy(rs.rand(1, *hw, 3).astype(np.float32))
                   .to(cuda_device).bfloat16() for _ in range(2))
    before = d2.deconv3d_s2.launches
    with torch.inference_mode():
        got = net(left, right).float()
    torch.cuda.synchronize()
    assert d2.deconv3d_s2.launches == before + 3
    routes = conv_ops.deconv3d_s2_routes
    try:
        conv_ops.deconv3d_s2_routes = lambda *args: False
        with torch.inference_mode():
            want = net(left, right).float()
    finally:
        conv_ops.deconv3d_s2_routes = routes
    assert d2.deconv3d_s2.launches == before + 3
    assert (got - want).abs().mean().item() < 0.05  # px, of a 0..32 range
    fp32 = params_from_numpy(spec, params, device=cuda_device)
    with torch.inference_mode():
        fp32(left.float(), right.float())
        with packed3d_lowering():
            net(left, right)
    layer = net.decoder3D["deconv3D_2"]
    a = torch.randn((1, 8, 17, 33, 64), device=cuda_device).bfloat16()
    a = a.permute(0, 4, 1, 2, 3).requires_grad_(True)
    skip = torch.randn((1, 16, 33, 65, 32), device=cuda_device).bfloat16()
    skip = skip.permute(0, 4, 1, 2, 3)
    layer.deconv_elu(a, (16, 33, 65), skip).float().sum().backward()
    torch.cuda.synchronize()
    assert d2.deconv3d_s2.launches == before + 3 and a.grad is not None
    sharding = conv_ops.current_sharding
    try:
        conv_ops.current_sharding = lambda: object()
        assert not conv_ops.deconv3d_s2_routes(
            a.detach(), layer.weight, skip, (16, 33, 65), 2,
            layer.kernel_s2)
    finally:
        conv_ops.current_sharding = sharding
    assert conv_ops.deconv3d_s2_routes(a.detach(), layer.weight, skip,
                                       (16, 33, 65), 2, layer.kernel_s2)


def _conv223_pinned_inputs(xshape, k_out):
    gen = torch.Generator().manual_seed(11)
    c = xshape[-1]
    xp = torch.randn(xshape, generator=gen).bfloat16()
    k = (torch.randn((2, 2, 3, k_out, c), generator=gen) * (12 * c) ** -0.5
         ).bfloat16()
    return xp, k, torch.randn(k_out, generator=gen)


@pytest.mark.parametrize("xshape,k_out", sorted(CONV223_PINNED), ids=str)
def test_conv223_bit_equal_to_its_pinned_output_on_card(cuda_device, xshape,
                                                        k_out):
    """conv223's (2, 2) instance of the shared pipeline gives, bit for bit,
    the output it gave as a kernel of its own."""
    xp, kt, bias = (t.to(cuda_device) for t in
                    _conv223_pinned_inputs(xshape, k_out))
    out = c223.conv223(xp, kt, bias, "kc").view(torch.int16).cpu().numpy()
    assert hashlib.sha256(out.tobytes()).hexdigest() == \
        CONV223_PINNED[(xshape, k_out)]


def test_encoder_runs_the_conv3d_k3_kernel_on_card(cuda_device):
    """A bf16 NVSmall forward launches the kernel once a stride-1 encoder
    layer, within bf16 noise of the same forward on the cuDNN route; an
    fp32 net and a bf16 forward that needs grad launch it never."""
    hw = (65, 129)
    spec = dataclasses.replace(STEREO_SPECS["nvsmall"], input_hw=hw,
                               max_disp=16)
    params = init_stereo_params(spec, seed=0)
    net = params_from_numpy(spec, params, device=cuda_device,
                            dtype=torch.bfloat16)
    rs = np.random.RandomState(1)
    left, right = (torch.from_numpy(rs.rand(1, *hw, 3).astype(np.float32))
                   .to(cuda_device).bfloat16() for _ in range(2))
    before = k3.conv3d_k3.launches
    with torch.inference_mode():
        got = net(left, right).float()
    torch.cuda.synchronize()
    assert k3.conv3d_k3.launches == before + 5
    routes = conv_ops.conv3d_k3_routes
    try:
        conv_ops.conv3d_k3_routes = lambda *args: False
        with torch.inference_mode():
            want = net(left, right).float()
    finally:
        conv_ops.conv3d_k3_routes = routes
    assert k3.conv3d_k3.launches == before + 5
    assert (got - want).abs().mean().item() < 0.05  # px, of a 0..32 range
    fp32 = params_from_numpy(spec, params, device=cuda_device)
    with torch.inference_mode():
        fp32(left.float(), right.float())
    layer = net.encoder3D["conv3D_2"]
    a = torch.randn((1, 8, 33, 65, 32), device=cuda_device).bfloat16()
    a = a.permute(0, 4, 1, 2, 3).requires_grad_(True)
    layer.conv_elu(a).float().sum().backward()
    torch.cuda.synchronize()
    assert k3.conv3d_k3.launches == before + 5 and a.grad is not None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,d", EMIT_SHAPES + [NVSMALL, RESNET18_3D])
def test_packed_emit_kernel_matches_plain_on_card(cuda_device, shape, d,
                                                  dtype):
    n, h, w, k = shape
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(3)
    la, rb, bias = (torch.randn(s, generator=gen, device=cuda_device)
                    for s in ((n, h, w, 3 * k), (n, h, w, 6 * k), (k,)))
    la, rb = la.to(dtype), rb.to(dtype)
    before = (emit.fused_cv_emit.launches, emit.fused_cv_emit.packed_launches)
    got = emit.fused_cv_emit(la, rb, bias, d, layout="dh_shifted")
    torch.cuda.synchronize()
    assert (emit.fused_cv_emit.launches,
            emit.fused_cv_emit.packed_launches) == (before[0] + 1,
                                                    before[1] + 1)
    want = emit.fused_cv_emit_plain(la, rb, bias, d, layout="dh_shifted")
    assert got.dtype == want.dtype and got.shape == want.shape == (
        n, (d + 1) // 2 + 1, (h + 1) // 2 + 1, w, 4 * k)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    else:
        assert _ulp_ok(got, want, 1e-4)
    # the padding slots and rows are exactly zero (after bias and ELU)
    assert not got[:, 0, :, :, :k].any() and not got[:, :, 0, :, :2 * k].any()


def test_packed_kernels_never_take_plain_version(cuda_device, monkeypatch):
    def plain(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(c223, "conv223_plain", plain)
    monkeypatch.setattr(emit, "fused_cv_emit_plain", plain)
    xp, k, bias = _conv223_inputs(cuda_device, (1, 3, 4, 9, 16), 16,
                                  torch.bfloat16)
    assert c223.conv223(xp, k, bias).is_cuda
    la, rb = _pair(cuda_device, (1, 4, 40, 6))
    assert emit.fused_cv_emit(la, torch.cat([rb, rb], -1), None, 5,
                              layout="dh_shifted").is_cuda


def test_packed_kernels_take_plain_version_on_cpu_tensors():
    """No card needed: CPU tensors take the plain versions and count no
    launch."""
    gen = torch.Generator().manual_seed(4)
    xp, k, bias = (torch.randn(s, generator=gen) for s in
                   ((1, 3, 4, 9, 16), (2, 2, 3, 16, 16), (16,)))
    la, rb = (torch.randn(s, generator=gen) for s in ((1, 4, 9, 6),
                                                      (1, 4, 9, 12)))
    before = (c223.conv223.launches, emit.fused_cv_emit.launches,
              emit.fused_cv_emit.packed_launches)
    assert torch.equal(c223.conv223(xp, k, bias),
                       c223.conv223_plain(xp, k, bias))
    assert torch.equal(
        emit.fused_cv_emit(la, rb, bias[:2], 5, layout="dh_shifted"),
        emit.fused_cv_emit_plain(la, rb, bias[:2], 5, layout="dh_shifted"))
    assert (c223.conv223.launches, emit.fused_cv_emit.launches,
            emit.fused_cv_emit.packed_launches) == before


@pytest.mark.parametrize("bad", ["strided", "channels", "out_channels",
                                 "wide", "dtype", "device", "bias"])
def test_conv223_wrapper_raises_on_bad_cuda_input(cuda_device, bad):
    xp, k, bias = _conv223_inputs(cuda_device, (1, 3, 4, 9, 32), 32,
                                  torch.bfloat16)
    if bad == "strided":
        xp = xp[:, :, :, ::2]
    elif bad == "channels":
        xp, k = xp[..., :24].contiguous(), k[:, :, :, :24].contiguous()
    elif bad == "out_channels":
        k, bias = k[..., :24].contiguous(), bias[:24]
    elif bad == "wide":
        xp = torch.zeros((1, 3, 4, 9, 272), device=cuda_device,
                         dtype=torch.bfloat16)
        k = torch.zeros((2, 2, 3, 272, 32), device=cuda_device,
                        dtype=torch.bfloat16)
    elif bad == "dtype":
        xp, k = xp.half(), k.half()
    elif bad == "device":
        k = k.cpu()
    else:
        bias = bias[:16]
    before = c223.conv223.launches
    with pytest.raises((TypeError, ValueError)):
        c223.conv223(xp, k, bias)
    assert c223.conv223.launches == before


def test_stereo_node_packed_head_serves_through_the_kernels(cuda_device):
    hw = (65, 129)
    spec = dataclasses.replace(STEREO_SPECS["nvtiny"], input_hw=hw,
                               max_disp=8)
    node = StereoNode(spec, init_stereo_params(spec, seed=0),
                      dtype=torch.bfloat16)
    rs = np.random.RandomState(0)
    left, right = (rs.randint(0, 256, hw + (3,)).astype(np.uint8)
                   for _ in range(2))
    before = (c223.conv223.launches, emit.fused_cv_emit.packed_launches,
              concat.cost_volume_concat.launches)
    with packed3d_lowering():
        disp = node(left, right)
    assert (c223.conv223.launches, emit.fused_cv_emit.packed_launches,
            concat.cost_volume_concat.launches) == (before[0] + 1,
                                                    before[1] + 1, before[2])
    assert disp.shape == hw and disp.dtype == np.float32
    assert np.isfinite(disp).all()
    assert 0 <= disp.min() <= disp.max() <= spec.full_max_disp
    unpacked = node(left, right)
    # one bf16 frame through two lowerings of one function (PERF.md)
    assert np.abs(disp - unpacked).mean() < 0.1


# ------------------------------- backward kernels and the autograd refusal

# The training path's features: the 160x512 crop at half resolution, batch
# 4 (ResNet18-2D: C = 32, D = 48; NVTiny: C = 8, D = 24).
TRAIN_CORR = ((4, 80, 256, 32), 48)
TRAIN_CONCAT = [((4, 80, 256, 8), 24), ((4, 80, 256, 32), 48)]
# The corr backward's plan (`bwd_tile_plan`): rows of several segments with
# their halos; C = 12 (no 16-byte loads in bf16) over two segments; D = 70
# in two disparity chunks over three. The concat backward's words: C = 12
# (8 bytes in bf16).
CORR_BWD_EDGES = [((2, 3, 150, 32), 48), ((1, 2, 200, 12), 20),
                  ((1, 2, 300, 16), 70)]
CONCAT_BWD_EDGES = [((1, 3, 40, 12), 9)]


def _bwd_ok(got, want):
    """fp32: within 1e-5 of the largest magnitude (summation order only);
    bf16: both round an fp32 sum once, so within one bf16 step plus that."""
    atol = 1e-5 * (want.float().abs().max().item() + 1.0)
    if got.dtype == torch.float32:
        return bool(((got - want).abs() <= atol).all())
    return _ulp_ok(got, want, atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["dlast", "hdw", "softargmax"])
@pytest.mark.parametrize("shape,d",
                         SHAPES + CORR_EDGES + CORR_BWD_EDGES + [TRAIN_CORR])
def test_corr_bwd_kernel_matches_plain_on_card(cuda_device, shape, d, dtype,
                                               mode):
    left, right = _pair(cuda_device, shape, dtype, seed=2)
    # scaled by 1/sqrt(C): the volume is O(1), as trained features make it
    left, right = (t * shape[-1] ** -0.5 for t in (left, right))
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(3)
    n, h, w, _ = shape
    gshape = {"dlast": (n, h, w, d), "hdw": (n, h, d, w),
              "softargmax": (n, h, w)}[mode]
    g = torch.randn(gshape, generator=gen, device=cuda_device)
    if mode == "hdw":
        g = g.to(dtype)
    if mode == "softargmax":
        counter = corr.corr_softargmax_bwd
        before = counter.launches
        got = corr.corr_softargmax_bwd(left, right, g, d)
        want = corr.corr_softargmax_bwd_plain(left, right, g, d)
    else:
        counter = corr.corr_cost_volume_bwd
        before = counter.launches
        got = corr.corr_cost_volume_bwd(left, right, g, d, layout=mode)
        want = corr.corr_cost_volume_bwd_plain(left, right, g, d,
                                               layout=mode)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == dtype and a.shape == b.shape == shape
        assert _bwd_ok(a, b), float((a.float() - b.float()).abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,d",
                         CONCAT_SHAPES + CONCAT_BWD_EDGES + TRAIN_CONCAT)
def test_concat_bwd_kernel_matches_plain_on_card(cuda_device, shape, d,
                                                 dtype):
    n, h, w, c = shape
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(4)
    g = torch.randn((n, d, h, w, 2 * c), generator=gen,
                    device=cuda_device).to(dtype)
    before = concat.cost_volume_concat_bwd.launches
    got = concat.cost_volume_concat_bwd(g, d)
    torch.cuda.synchronize()
    assert concat.cost_volume_concat_bwd.launches == before + 1
    want = concat.cost_volume_concat_bwd_plain(g, d)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == dtype and a.shape == b.shape == shape
        assert _bwd_ok(a, b), float((a.float() - b.float()).abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", ["softargmax", "dlast", "hdw", "concat"])
def test_bwd_kernels_repeat_bit_for_bit_on_card(cuda_device, form, dtype):
    """No atomics: two launches on the same inputs give the same bits (a
    remat recompute or a repeated step does), at the training shapes and a
    segmented row."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(6)
    cases = (TRAIN_CONCAT if form == "concat"
             else [TRAIN_CORR, CORR_BWD_EDGES[0]])
    for shape, d in cases:
        n, h, w, c = shape
        if form == "concat":
            g = torch.randn((n, d, h, w, 2 * c), generator=gen,
                            device=cuda_device).to(dtype)
            runs = [concat.cost_volume_concat_bwd(g, d) for _ in range(2)]
        else:
            left, right = _pair(cuda_device, shape, dtype, seed=7)
            gshape = {"dlast": (n, h, w, d), "hdw": (n, h, d, w),
                      "softargmax": (n, h, w)}[form]
            g = torch.randn(gshape, generator=gen, device=cuda_device)
            if form == "hdw":
                g = g.to(dtype)
            if form == "softargmax":
                runs = [corr.corr_softargmax_bwd(left, right, g, d)
                        for _ in range(2)]
            else:
                runs = [corr.corr_cost_volume_bwd(left, right, g, d,
                                                  layout=form)
                        for _ in range(2)]
        torch.cuda.synchronize()
        for a, b in zip(*runs):
            assert torch.equal(a, b)


def _kernel_calls(device, requires_grad):
    """(counter, call, backward counter) of each of the six wrapper entry
    points on CUDA inputs that require grad (or not)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(5)

    def t(*shape):
        return torch.randn(shape, generator=gen, device=device
                           ).requires_grad_(requires_grad)

    left, right = t(1, 3, 40, 8), t(1, 3, 40, 8)
    la, rb, b = t(1, 3, 40, 6), t(1, 3, 40, 12), t(2)
    xp, k, kb = t(1, 3, 4, 9, 16), t(2, 2, 3, 16, 16), t(16)
    x3, kt3 = t(1, 3, 4, 9, 16).bfloat16(), t(3, 3, 3, 16, 16)
    y2, kt2, s2 = (t(1, 2, 3, 9, 16).bfloat16(), t(27, 16, 16),
                   t(1, 4, 6, 18, 16).bfloat16())
    return {
        "corr_cost_volume": (corr.corr_cost_volume,
                             lambda: corr.corr_cost_volume(left, right, 5),
                             corr.corr_cost_volume_bwd),
        "corr_softargmax": (corr.corr_softargmax,
                            lambda: corr.corr_softargmax(left, right, 5),
                            corr.corr_softargmax_bwd),
        "cost_volume_concat": (concat.cost_volume_concat,
                               lambda: concat.cost_volume_concat(left, right,
                                                                 5),
                               concat.cost_volume_concat_bwd),
        "fused_cv_emit": (emit.fused_cv_emit,
                          lambda: emit.fused_cv_emit(la, rb, b, 5), None),
        "conv223": (c223.conv223, lambda: c223.conv223(xp, k, kb), None),
        "conv3d_k3": (k3.conv3d_k3,
                      lambda: k3.conv3d_k3(x3, kt3.bfloat16(), kb), None),
        "deconv3d_s2": (d2.deconv3d_s2,
                        lambda: d2.deconv3d_s2(y2, kt2.bfloat16(), kb, s2,
                                               (4, 6, 18)), None)}


@pytest.mark.parametrize("name", ["fused_cv_emit", "conv223", "conv3d_k3",
                                  "deconv3d_s2"])
def test_kernel_wrappers_refuse_autograd_on_card(cuda_device, name):
    counter, call, _ = _kernel_calls(cuda_device, True)[name]
    before = counter.launches
    with pytest.raises(RuntimeError, match=r"no backward yet.*item 2"):
        call()
    assert counter.launches == before
    for ctx in (torch.no_grad, torch.inference_mode):
        with ctx():
            assert call().is_cuda
    counter, call, _ = _kernel_calls(cuda_device, False)[name]
    assert call().is_cuda  # grad mode on, no input requires grad
    torch.cuda.synchronize()
    assert counter.launches == before + 3


@pytest.mark.parametrize("name", ["corr_cost_volume", "corr_softargmax",
                                  "cost_volume_concat"])
def test_kernel_wrappers_backward_on_card(cuda_device, name, monkeypatch):
    """Through autograd on the card: the forward kernel, then the backward
    kernel, never a plain version; the grads are the plain backward's."""
    left, right = (t.requires_grad_() for t in
                   _pair(cuda_device, (1, 3, 40, 8), seed=6))
    fwd, bwd, plain_bwd = {
        "corr_cost_volume": (corr.corr_cost_volume, corr.corr_cost_volume_bwd,
                             lambda g: corr.corr_cost_volume_bwd_plain(
                                 left.detach(), right.detach(), g, 5)),
        "corr_softargmax": (corr.corr_softargmax, corr.corr_softargmax_bwd,
                            lambda g: corr.corr_softargmax_bwd_plain(
                                left.detach(), right.detach(), g, 5)),
        "cost_volume_concat": (concat.cost_volume_concat,
                               concat.cost_volume_concat_bwd,
                               lambda g: concat.cost_volume_concat_bwd_plain(
                                   g, 5))}[name]
    before = (fwd.launches, bwd.launches)
    out = fwd(left, right, 5)
    g = torch.randn_like(out)
    module = concat if name == "cost_volume_concat" else corr
    with monkeypatch.context() as m:
        for attr in dir(module):
            if attr.endswith("_plain"):
                m.setattr(module, attr, lambda *a, **k: pytest.fail(
                    "a CUDA tensor reached a plain version"))
        out.backward(g)
        torch.cuda.synchronize()
    assert (fwd.launches, bwd.launches) == (before[0] + 1, before[1] + 1)
    for got, want in zip((left.grad, right.grad), plain_bwd(g)):
        assert _bwd_ok(got, want)


# ---------------------------------------------------------- TrailNet / YOLO

KERNEL_COUNTERS = (corr.corr_cost_volume, corr.corr_softargmax,
                   concat.cost_volume_concat, emit.fused_cv_emit, c223.conv223)


def _trailnet(form, dtype, device):
    tree = params_from_w8_npz(TRAILNET_W8)
    if form == "native":
        return trailnet.params_from_numpy(tree, device=device, dtype=dtype)
    return CaffeNet(parse_prototxt(emit_trailnet_prototxt()),
                    native_params_to_blobs(tree), dtype=dtype, device=device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", ["caffe", "native"])
def test_trailnet_on_card_matches_cpu(cuda_device, form, dtype):
    frames = np.random.RandomState(0).randint(0, 256, (2, 180, 320, 3)
                                              ).astype(np.uint8)
    x = torch.from_numpy(frames)
    before = [c.launches for c in KERNEL_COUNTERS]
    with torch.inference_mode():
        want = _trailnet(form, torch.float32, "cpu")(x).numpy()
        got = _trailnet(form, dtype, cuda_device)(x.to(cuda_device))
        got = got.float().cpu().numpy()
    assert [c.launches for c in KERNEL_COUNTERS] == before
    assert got.shape == (2, 6) and np.isfinite(got).all()
    err = np.abs(got - want)
    if dtype == torch.float32:
        # TF32 off: summation order only, in probability units
        assert err.max() <= 1e-4, err.max()
    else:
        # one bf16 rounding per layer, against the CPU's fp32
        assert err.mean() <= 1e-2, err.mean()


def test_trailnet_node_on_card_launches_no_kernel(cuda_device):
    node = TrailNetNode(_trailnet("caffe", torch.bfloat16, None))
    frame = np.random.RandomState(1).randint(0, 256, (180, 320, 3)).astype(
        np.uint8)
    before = [c.launches for c in KERNEL_COUNTERS]
    out = node(frame)
    assert [c.launches for c in KERNEL_COUNTERS] == before
    assert out.shape == (6,) and out.dtype == np.float32
    np.testing.assert_allclose(out.reshape(2, 3).sum(-1), 1.0, atol=2e-2)


YOLO_STANDIN = """
input: "data"
input_shape { dim: 1 dim: 3 dim: 448 dim: 448 }
layer { name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
        convolution_param { num_output: 8 kernel_size: 7 stride: 4 pad: 3 } }
layer { name: "relu1" type: "ReLU" bottom: "conv1" top: "conv1"
        relu_param { negative_slope: 0.1 } }
layer { name: "pool1" type: "Pooling" bottom: "conv1" top: "pool1"
        pooling_param { pool: MAX kernel_size: 4 stride: 4 } }
layer { name: "pool2" type: "Pooling" bottom: "pool1" top: "pool2"
        pooling_param { pool: AVE kernel_size: 4 stride: 4 } }
layer { name: "fc" type: "InnerProduct" bottom: "pool2" top: "fc"
        inner_product_param { num_output: 1470 } }
"""


def test_yolo_node_on_card_matches_cpu(cuda_device):
    """A YOLO-shaped graph (not the YOLO model), random weights."""
    frame = np.random.RandomState(2).randint(0, 256, (448, 448, 3)).astype(
        np.uint8)
    nets = {d: CaffeNet(parse_prototxt(YOLO_STANDIN), seed=3, device=d)
            for d in ("cpu", cuda_device)}
    with torch.inference_mode():
        raw = {d: net(frame).float().cpu().numpy()[0]
               for d, net in nets.items()}
    assert raw["cpu"].shape == (1470,)
    np.testing.assert_allclose(raw[cuda_device], raw["cpu"], rtol=0,
                               atol=1e-4 * max(1.0, np.abs(raw["cpu"]).max()))
    node = YoloNode(nets[cuda_device], prob_threshold=0.01)
    out = node(frame)
    assert out.dtype == np.float32 and out.ndim == 2 and out.shape[1] == 6
    np.testing.assert_array_equal(out, yolo.postprocess(
        raw[cuda_device], 448, 448, prob_threshold=0.01))


# ------------------------------------- the serving runtime on the card

SERVE_HW = (65, 129)


def _serve_frames(n, hw=SERVE_HW, seed=0):
    rs = np.random.RandomState(seed)
    return [(rs.randint(0, 256, hw + (3,)).astype(np.uint8),
             rs.randint(0, 256, hw + (3,)).astype(np.uint8))
            for _ in range(n)]


def _node_2d(**kw):
    spec = dataclasses.replace(STEREO_SPECS["resnet18_2d"],
                               input_hw=SERVE_HW, max_disp=8)
    return StereoNode(spec, init_stereo_params(spec, seed=0),
                      dtype=torch.bfloat16, **kw)


@pytest.mark.parametrize("overlap", [1, 2])
def test_overlapped_stereo_node_bit_equal_on_card(cuda_device, overlap):
    """Frames in flight on the node's own stream: call k returns frame
    k - N under its stamp, bit-equal to the synchronous node (the same
    batch-1 kernels), over more frames than the staging ring holds."""
    from redtail_tpu_torch import native
    frames = _serve_frames(8)
    sync = _node_2d()
    want = [sync(*f) for f in frames]
    node = _node_2d(overlap=overlap)
    assert node._stream is not None and \
        node._stream != torch.cuda.current_stream()
    packs = native.pack_s2d.native_calls
    before = corr.corr_softargmax.launches
    outs = [node(*f, stamp=float(k)) for k, f in enumerate(frames)]
    assert corr.corr_softargmax.launches == before + len(frames)
    assert native.pack_s2d.native_calls == packs + 2 * len(frames)
    assert outs[:overlap] == [None] * overlap
    for k, out in enumerate(outs[overlap:]):
        assert out.stamp == float(k)
        np.testing.assert_array_equal(out.data, want[k])
    node.drain()
    assert not node._inflight


def test_microbatched_nodes_run_the_kernels_at_batch_2(cuda_device):
    """overlap=1, microbatch=2: one launch a batch of two frames, within
    the bf16 gates of the synchronous node (cuDNN may choose other
    algorithms at N = 2): ResNet18-2D through the corr kernel, NVTiny
    through the emission (fused head) and conv223 (packed head)."""
    frames = _serve_frames(4)
    sync, node = _node_2d(), _node_2d(overlap=1, microbatch=2)
    before = corr.corr_softargmax.launches
    outs = [node(*f, stamp=float(k)) for k, f in enumerate(frames)]
    assert corr.corr_softargmax.launches == before + 2
    assert outs[:3] == [None] * 3 and [o.stamp for o in outs[3]] == [0, 1]
    for o in outs[3]:
        err = np.abs(o.data - sync(*frames[int(o.stamp)])) / SERVE_HW[1]
        assert err.mean() < 1e-2  # sigmoid units, as the bf16 slice gate
    spec = dataclasses.replace(STEREO_SPECS["nvtiny"], input_hw=SERVE_HW,
                               max_disp=8)
    params = init_stereo_params(spec, seed=0)
    def counts(counters):
        return [c.launches + getattr(c, "packed_launches", 0)
                for c in counters]

    for lowering, counters in (
            (contextlib.nullcontext, [emit.fused_cv_emit]),
            (packed3d_lowering, [c223.conv223, emit.fused_cv_emit])):
        sync = StereoNode(spec, params, dtype=torch.bfloat16)
        node = StereoNode(spec, params, dtype=torch.bfloat16, overlap=1,
                          microbatch=2)
        with lowering():
            before = counts(counters)
            want = [sync(*f) for f in frames]
            per_frame = [(a - b) // len(frames)
                         for a, b in zip(counts(counters), before)]
            before = counts(counters)
            outs = [node(*f, stamp=float(k)) for k, f in enumerate(frames)]
            node.drain()
            after = counts(counters)
        # two dispatches of two frames: each launch covers a batch
        assert min(per_frame) >= 1
        assert [a - b for a, b in zip(after, before)] == \
            [2 * n for n in per_frame]
        for o in outs[3]:
            assert np.abs(o.data - want[int(o.stamp)]).mean() < 0.1  # px


def test_u16_wire_on_card(cuda_device):
    frames = _serve_frames(2)
    f32, u16 = _node_2d(), _node_2d(wire="u16")
    for f in frames:
        a, b = f32(*f), u16(*f)
        assert b.dtype == np.float32 and (b * 64 == np.round(b * 64)).all()
        assert np.abs(a - b).max() <= 1.0 / 128.0 + 1e-6


def test_overlapped_node_on_a_graph_thread_on_card(cuda_device):
    """The graph's thread starts with grad mode on; the node enters
    inference mode there, so the kernels serve and no frame errors."""
    from redtail_tpu_torch.runtime import NodeGraph
    node = _node_2d(overlap=1)
    g = NodeGraph()
    g.add_node("stereo", node, ["l", "r"], "disp", max_rate_hz=100,
               sync_slop=0.05)
    g.start()
    try:
        for k, (left, right) in enumerate(_serve_frames(4)):
            g.topic("l").publish(left, stamp=float(k))
            g.topic("r").publish(right, stamp=float(k))
            g.spin_until(lambda: g.nodes["stereo"].processed > k, timeout=5)
        assert g.spin_until(lambda: g.topic("disp").count >= 2, timeout=5)
    finally:
        g.stop()
    assert g.nodes["stereo"].errors == 0, g.nodes["stereo"].last_error


def test_fused_ingest_on_card_matches_cpu(cuda_device):
    """The card and the CPU round the float32 source coordinates apart:
    a weight moves by up to two ulps of the largest coordinate (1025:
    1.2e-4), the [0, 1] output by as much (measured 3.7e-5)."""
    from redtail_tpu_torch.ops.preprocess import fused_ingest
    x = np.random.RandomState(3).randint(0, 256, (2, 321, 1025, 3)).astype(
        np.uint8)
    atol = 2 * float(np.spacing(np.float32(1025)))
    for hw in ((180, 320), (400, 1100)):
        got = fused_ingest(x, hw)
        assert got.is_cuda
        want = fused_ingest(x, hw, device="cpu")
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=atol)


def test_real_trailnet_sim_on_card_matches_cpu(cuda_device):
    from redtail_tpu_torch.apps import sim_app
    from redtail_tpu_torch.control import Pose
    card = sim_app.make_real_trailnet()
    cpu = sim_app.make_real_trailnet(device="cpu")
    pose = Pose(np.array([5.0, 0.5, 1.5]))
    np.testing.assert_allclose(card(pose, np.random.RandomState(0)),
                               cpu(pose, np.random.RandomState(0)),
                               rtol=0, atol=1e-4)


# ------------------------------------------------------ quantized rungs


def _conditioned(tree, seed=7):
    """Random biases, and residual-branch and feature-head weights scaled by
    0.3 so ResNet18-2D's cost volume is O(1), as a trained network's is
    (tests/test_torch_stereo.py `conditioned`): under plain He-init the
    soft-argmax turns bf16 rounding into pixels of output."""
    rs = np.random.RandomState(seed)

    def walk(node, path):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v, f"{path}/{k}")
            elif k == "biases":
                out[k] = (rs.randn(*v.shape) * 0.1).astype(np.float32)
            elif path.endswith(("res_conv2", "encoder2D_out")):
                out[k] = (v * 0.3).astype(np.float32)
            else:
                out[k] = v
        return out
    return walk(tree, "")


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("c_in", [32, 128, 256],
                         ids=["K=288", "K=1152", "K=2304"])
def test_conv2d_int8_on_card_bit_equal_to_cpu(cuda_device, c_in, stride):
    """Both exact routes on the card (fp32 carriers at K = 288, im2col and
    `torch._int_mm` above the 2**24 bound, K and N padded to multiples of
    8) give the CPU's integer sums, so the dequantized outputs are
    bit-equal; a 3x3 VALID input (one output row) pads M past 16."""
    from redtail_tpu_torch.quant import ptq
    rs = np.random.RandomState(c_in)
    for shape, padding in (((2, c_in, 13, 21), "SAME"),
                           ((1, c_in, 3, 3), "VALID")):
        x = rs.randint(-127, 128, shape).astype(np.int8)
        w = rs.randint(-127, 128, (20, c_in, 3, 3)).astype(np.int8)
        ws = torch.from_numpy(((rs.rand(20) + 0.5) * 1e-3).astype(np.float32))
        b = torch.from_numpy(rs.randn(20).astype(np.float32))
        for out_dtype in (torch.float32, torch.bfloat16):
            got, want = (ptq.conv2d_int8_nchw(
                torch.from_numpy(x).to(dev), torch.from_numpy(w).to(dev),
                x_scale=0.0123, w_scale=ws, bias=b.to(dev), stride=stride,
                padding=padding, out_dtype=out_dtype).cpu()
                for dev in (cuda_device, "cpu"))
            assert torch.equal(got, want)


@pytest.mark.parametrize("x_shape,w_shape,stride", [
    ((2, 3, 41, 65), (32, 3, 5, 5), 2),     # ResNet18-2D's conv1: K = 75
    ((1, 32, 13, 21), (32, 32, 3, 3), 1),   # K = 288, M = 273
    ((2, 256, 9, 11), (20, 256, 3, 3), 1),  # K = 2304, M = 198
    ((1, 96, 5, 40), (16, 96, 1, 1), 1)])   # K = 96, M = 200
def test_int_mm_route_on_card_at_rows_off_32(cuda_device, x_shape, w_shape,
                                            stride):
    """The im2col + `torch._int_mm` route at row counts M that are not a
    multiple of 32 and small K, shapes whose unpadded product cuBLASLt
    refuses on the H100: the rows padded to 32, it gives the CPU's exact
    int32 sums."""
    from redtail_tpu_torch.quant import ptq
    rs = np.random.RandomState(sum(x_shape))
    x = torch.from_numpy(rs.randint(-127, 128, x_shape).astype(np.int8))
    w = torch.from_numpy(rs.randint(-127, 128, w_shape).astype(np.int8))
    pads = ptq._conv_pads("SAME", x_shape[2:], w_shape[2:], (stride,) * 2)
    got = ptq._int_mm_conv(x.to(cuda_device), w.to(cuda_device),
                           (stride,) * 2, pads).cpu()
    assert torch.equal(got, ptq._int_mm_conv(x, w, (stride,) * 2, pads))


def test_quantize_act_on_card_bit_equal_to_cpu(cuda_device):
    """The division by the scale is a true fp32 division on the card too
    (the scale lies on the device: a host scalar would be a reciprocal
    multiply), rounding half to even."""
    from redtail_tpu_torch.quant import ptq
    x = torch.from_numpy((np.random.RandomState(1).randn(2, 16, 33, 65) * 5)
                         .astype(np.float32))
    x.view(-1)[:4] = torch.tensor([0.25, 0.75, -0.25, 1.25])
    for scale in (0.5, 0.0371, np.float32(1.7)):
        assert torch.equal(ptq.quantize_act(x.to(cuda_device), scale).cpu(),
                           ptq.quantize_act(x, scale))


@pytest.mark.parametrize("name", ["conv2d", "conv3d", "conv2d_transpose",
                                  "conv3d_transpose"])
def test_round_once_convs_on_card_within_a_step_of_cpu(cuda_device, name):
    """bf16 convs on fp32 carriers with TF32 allowed: exact products, fp32
    sums in another order than the CPU's, one rounding: at most one bf16
    step apart."""
    from redtail_tpu_torch.ops import convolution as conv
    gen = torch.Generator().manual_seed(3)
    nd = 3 if "3d" in name else 2
    x = torch.randn((2,) + (7, 12, 17)[-nd:] + (16,), generator=gen)
    w = torch.randn((3,) * nd + (16, 24), generator=gen) / 8
    b = torch.randn(24, generator=gen)
    kw = {}
    if "transpose" in name:  # I = 24, the transpose's output channels
        w = w.transpose(-1, -2).contiguous()
        kw["out_spatial"] = tuple(2 * s for s in x.shape[1:-1])
    x, w, b = (t.to(torch.bfloat16) for t in (x, w, b))
    fn = getattr(conv, name)
    got = fn(x.to(cuda_device), w.to(cuda_device), b.to(cuda_device), **kw)
    want = fn(x, w, b, **kw)
    assert got.dtype == torch.bfloat16
    # one bf16 step of the larger magnitude, plus the fp32 sums' order
    # error (1e-4 at these O(1) sums) where cancellation leaves a result
    # near zero
    got, want = got.cpu().float(), want.float()
    mag = torch.maximum(got.abs(), want.abs()).clamp_min(2.0 ** -126)
    step = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    assert bool(((got - want).abs() <= step + 1e-4).all())


@pytest.mark.parametrize("quantize", ["w8", "int8"])
def test_stereo_node_quantized_serves_through_the_kernel_on_card(
        cuda_device, quantize):
    """ResNet18-2D at 65x129, bf16: the quantized node on the card runs
    the corr kernel once a frame and stays within the bf16 gate (a mean of
    1e-2 sigmoid units, in pixels) of the same node on the CPU."""
    hw = (65, 129)
    spec = dataclasses.replace(STEREO_SPECS["resnet18_2d"], input_hw=hw,
                               max_disp=8)
    tree = _conditioned(init_stereo_params(spec, seed=0))
    rs = np.random.RandomState(2)
    calib = [tuple(rs.randint(0, 256, hw + (3,)).astype(np.uint8)
                   for _ in range(2))]
    kw = {"calib_frames": calib} if quantize == "int8" else {}
    card = StereoNode(spec, tree, dtype=torch.bfloat16, quantize=quantize,
                      **kw)
    cpu = StereoNode(spec, tree, dtype=torch.float32, device="cpu",
                     quantize=quantize, **kw)
    frame = calib[0]
    before = corr.corr_softargmax.launches
    got = card(*frame)
    assert corr.corr_softargmax.launches == before + 1
    assert card._s2d == (quantize != "int8")
    assert got.shape == hw and np.isfinite(got).all()
    assert np.abs(got - cpu(*frame)).mean() < 1e-2 * hw[1]


def test_trt_blob_net_on_card_bit_equal_to_tree(cuda_device, tmp_path):
    """NVTiny from an fp32 TRT blob serves bit-equal to the tree it was
    written from, in fp32 with cuDNN's deterministic algorithms."""
    from redtail_tpu_torch.io import read_trt_weights, write_trt_weights
    from redtail_tpu_torch.models import (params_from_trt_blob,
                                          params_to_trt_blob)

    hw = (65, 129)
    spec = dataclasses.replace(STEREO_SPECS["nvtiny"], input_hw=hw,
                               max_disp=8)
    tree = init_stereo_params(spec, seed=1)
    blob = params_to_trt_blob(spec, tree)
    write_trt_weights(blob, tmp_path / "w.trtw")
    loaded = params_from_trt_blob(spec, read_trt_weights(tmp_path / "w.trtw"))
    rs = np.random.RandomState(3)
    frame = tuple(rs.randint(0, 256, hw + (3,)).astype(np.uint8)
                  for _ in range(2))
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        want = StereoNode(spec, tree, dtype=torch.float32)(*frame)
        got = StereoNode(spec, loaded, dtype=torch.float32)(*frame)
    finally:
        torch.backends.cudnn.deterministic = saved
    assert np.array_equal(got, want)


@pytest.mark.parametrize("widen", [False, True],
                         ids=["as-is", "launch-widened"])
def test_fp32_trailnet_beside_bf16_stereo_thread_bit_equal(cuda_device,
                                                           monkeypatch,
                                                           widen):
    """`pipeline_app` runs a bf16 StereoNode (its convs with TF32 allowed)
    and an fp32 TrailNetNode (TF32 off) on threads of their own, and the
    switches are process-wide: TrailNet served while the stereo thread
    runs frame after frame is bit-equal to TrailNet served alone.
    ``launch-widened``: each port conv sleeps 0.2 ms (dropping the GIL)
    between setting the switches and launching, as a slow launch would,
    so the other thread's switches would land inside every window."""
    import threading
    import time
    import types

    from redtail_tpu_torch.ops import convolution as conv

    if widen:
        def slow(fn):
            def call(*args, **kw):
                time.sleep(2e-4)
                return fn(*args, **kw)
            return call
        for table in (conv._CONV, conv._CONV_T):
            for k, fn in list(table.items()):
                monkeypatch.setitem(table, k, slow(fn))
        monkeypatch.setattr(conv, "F", types.SimpleNamespace(
            conv2d=slow(torch.nn.functional.conv2d),
            linear=slow(torch.nn.functional.linear),
            pad=torch.nn.functional.pad))
    spec = dataclasses.replace(STEREO_SPECS["resnet18_2d"],
                               input_hw=(161, 513), max_disp=24)
    stereo = StereoNode(spec, _conditioned(init_stereo_params(spec, seed=0)),
                        dtype=torch.bfloat16)
    pairs = _serve_frames(2, hw=(161, 513), seed=4)
    node = TrailNetNode(_trailnet("caffe", torch.float32, None))
    rs = np.random.RandomState(5)
    frames = [rs.randint(0, 256, (180, 320, 3)).astype(np.uint8)
              for _ in range(12)]
    alone = [node(f) for f in frames]
    stereo(*pairs[0])
    stop, served = threading.Event(), []

    def serve_stereo():
        while not stop.is_set():
            served.append(stereo(*pairs[len(served) % 2]))

    worker = threading.Thread(target=serve_stereo)
    worker.start()
    try:
        beside = [node(f) for f in frames]
    finally:
        stop.set()
        worker.join()
    assert len(served) >= 2
    assert all(np.array_equal(a, b) for a, b in zip(alone, beside))
