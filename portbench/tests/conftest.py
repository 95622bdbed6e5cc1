"""Settings of the benchmark's own tests: the checkout's root on the path,
the `cuda` marker, and torch held to two threads (the tests run under
several workers)."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (skips without one)")


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def card():
    """Skips the test where no NVIDIA card is visible (decided here, at the
    test, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("native toolchain unavailable: needs an NVIDIA card and "
                    "nvcc")
    return "cuda"
