"""The port on the card: the CUDA corr kernel against its plain version, the
wrapper's no-fallback rule, and a small model served through the kernel.

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
from redtail_tpu_torch.models import STEREO_SPECS, init_stereo_params
from redtail_tpu_torch.runtime import StereoNode

# (N, H, W, C), D: tests/test_kernels.py's pair, D == W, D > W, ragged W.
SHAPES = [((2, 14, 33, 8), 6), ((1, 3, 7, 4), 7), ((1, 3, 5, 4), 9),
          ((2, 7, 37, 8), 6)]
FLAGSHIP = ((1, 161, 513, 32), 48)

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
