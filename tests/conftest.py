"""Test configuration: force CPU backend with a virtual 8-device mesh.

Tests must run anywhere (CI, dev box) without TPU hardware; sharding tests
use the 8 virtual CPU devices. `bench.py` is what runs on the real chip.
"""

import os

# Must be set before jax initializes its backends. Note the env var
# JAX_PLATFORMS may be force-set by the host environment, so we also pin the
# platform via jax.config, which takes precedence.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")

from pathlib import Path

import numpy as np
import pytest

REFERENCE = Path("/root/reference")
GOLDEN_DIR = REFERENCE / "stereoDNN" / "tests" / "data"
LOCAL_GOLDEN_DIR = Path(__file__).parent / "data" / "golden_ops"

requires_reference = pytest.mark.skipif(
    not REFERENCE.is_dir(), reason="reference tree not mounted"
)

_golden_sets = [p for p in ("reference", "local")
                if (GOLDEN_DIR if p == "reference"
                    else LOCAL_GOLDEN_DIR).is_dir()]


@pytest.fixture(scope="session", params=_golden_sets)
def golden_dir(request):
    """Op-golden fixtures: the reference's TF-generated .bin files AND the
    framework-regenerated set (tools/make_golden_ops.py — independent
    torch/numpy oracle); each op test runs against every available set."""
    if not _golden_sets:
        pytest.skip("no golden data available")
    return GOLDEN_DIR if request.param == "reference" else LOCAL_GOLDEN_DIR


@pytest.fixture(scope="session")
def rng():
    return np.random.RandomState(12345)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long test, deselected by -m 'not slow'")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (skips without one)")
