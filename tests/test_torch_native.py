"""The port's binding of the C++ host runtime (`redtail_tpu_torch/native.py`)
against the JAX package's (`redtail_tpu/native.py`): the same source
(`native/redtail_native.cpp`), built by each package into its own
directory: the serving pack bit-equal, the float preprocessing within its
compile flags' rounding; the pack counts which path served it; the
mailbox keeps its latest-wins contract."""

import threading

import numpy as np
import pytest

from redtail_tpu import native as jnative

from redtail_tpu_torch import native
from redtail_tpu_torch.ops.space_to_depth import space_to_depth2_np

# tests/test_native.py's shapes: odd and even H and W, batch dims, 1, 4,
# 16 and 32 channels (the kernel takes C <= 16)
PACK_SHAPES = [(321, 1025, 3), (322, 1024, 3), (7, 9, 3), (8, 10, 1),
               (1, 5, 4), (2, 33, 41, 3), (6, 8, 16), (6, 8, 32)]


@pytest.fixture(scope="module")
def lib():
    if native.load() is None:
        pytest.skip("native toolchain unavailable: no C++ compiler to "
                    "build native/redtail_native.cpp")
    return native


@pytest.fixture(scope="module")
def jlib():
    if jnative.load(auto_build=True) is None:
        pytest.skip("native toolchain unavailable: the JAX package's "
                    "build failed")
    return jnative


def test_builds_into_the_port_build_directory(lib):
    path = native.library_path()
    assert path.exists() and path.parent == native.BUILD
    assert path.parent.parent.name == "redtail_tpu_torch"
    assert path.name.startswith("libredtail_native-")
    assert native.build() == path  # present: no rebuild


@pytest.mark.parametrize("swap", [True, False])
@pytest.mark.parametrize("shape", PACK_SHAPES, ids=str)
def test_pack_s2d_bit_equal_to_jax(lib, jlib, shape, swap):
    x = np.random.RandomState(sum(shape)).randint(0, 256, shape).astype(
        np.uint8)
    before = (native.pack_s2d.native_calls, native.pack_s2d.numpy_calls)
    got = native.pack_s2d(x, swap_rb=swap)
    want = jnative.pack_s2d(x, swap_rb=swap)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, space_to_depth2_np(x[..., ::-1] if swap else x))
    wide = shape[-1] > 16
    assert (native.pack_s2d.native_calls, native.pack_s2d.numpy_calls) == \
        (before[0] + (not wide), before[1] + wide)


def test_pack_s2d_counts_the_numpy_fallback(monkeypatch):
    """Without the library the pack is numpy's, bit-identical, and the
    numpy counter shows it."""
    monkeypatch.setattr(native, "load", lambda: None)
    x = np.random.RandomState(1).randint(0, 256, (9, 11, 3)).astype(
        np.uint8)
    before = (native.pack_s2d.native_calls, native.pack_s2d.numpy_calls)
    np.testing.assert_array_equal(native.pack_s2d(x, swap_rb=True),
                                  space_to_depth2_np(x[..., ::-1]))
    assert (native.pack_s2d.native_calls, native.pack_s2d.numpy_calls) == \
        (before[0], before[1] + 1)
    with pytest.raises(RuntimeError, match="not available"):
        native.preprocess_area(x, (4, 5))


def test_library_name_keys_the_toolchain(monkeypatch, tmp_path):
    """Another compiler or other flags name another file, so a library
    built elsewhere (another compiler, another host) is never loaded."""
    names = set()
    for version in ("1.0", "2.0"):
        fake = tmp_path / f"cxx-{version}"
        fake.write_text(f"#!/bin/sh\necho 'fake-cxx {version}'\n")
        fake.chmod(0o755)
        monkeypatch.setenv("CXX", str(fake))
        names.add(native.library_path().name)
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-g",))
    names.add(native.library_path().name)
    assert len(names) == 3
    assert native.library_path() == native.library_path()  # deterministic


def test_load_is_none_when_the_build_fails(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD", tmp_path / "build")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    native.load.cache_clear()
    try:
        assert native.load() is None
        with pytest.raises((OSError, RuntimeError)):
            native.build()
    finally:
        native.load.cache_clear()


@pytest.mark.parametrize("fn", ["preprocess_bilinear", "preprocess_area"])
@pytest.mark.parametrize("src,dst", [((64, 96, 3), (32, 48)),
                                     ((45, 70, 3), (64, 100)),
                                     ((321, 1025, 3), (161, 513))], ids=str)
def test_preprocess_matches_jax(lib, jlib, fn, src, dst):
    """The same source; the JAX package's build adds -march=native, whose
    fused multiply-adds round the float32 source coordinates differently:
    a weight moves by up to two ulps of the largest coordinate, the output
    by that times 255 x scale (measured at 321x1025 -> 161x513: 1.4e-5 at
    scale 1/255, a twentieth of the bound)."""
    img = np.random.RandomState(2).randint(0, 256, src).astype(np.uint8)
    coord_ulp = float(np.spacing(np.float32(max(src[:2]))))
    for kw in ({}, {"swap_rb": False, "scale": 1.0, "shift": -0.5}):
        got = getattr(native, fn)(img, dst, **kw)
        want = getattr(jnative, fn)(img, dst, **kw)
        assert got.shape == dst + (3,) and got.dtype == np.float32
        scale = kw.get("scale", 1.0 / 255.0)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2 * coord_ulp * 255 * scale)


def test_hwc_to_chw(lib):
    img = np.random.RandomState(3).rand(5, 7, 3).astype(np.float32)
    np.testing.assert_array_equal(native.hwc_to_chw(img),
                                  img.transpose(2, 0, 1))


def test_mailbox_latest_wins(lib):
    mb = native.NativeMailbox((4, 4), dtype=np.float32)
    frame, seq = mb.take(0)
    assert frame is None and seq == 0
    rs = np.random.RandomState(4)
    a, b = (rs.rand(4, 4).astype(np.float32) for _ in range(2))
    assert mb.publish(a) == 1
    assert mb.publish(b) == 2
    frame, seq = mb.take(0)
    assert seq == 2
    np.testing.assert_array_equal(frame, b)
    assert mb.take(seq) == (None, seq)
    with pytest.raises(ValueError, match="bytes"):
        mb.publish(np.zeros(3, np.float32))
    mb.close()


def test_mailbox_threaded_producer_sees_the_last_frame(lib):
    """A producer thread publishes 2000 frames while the consumer takes:
    no torn frame, values never go back, and the last frame is taken,
    once more after the join (the consumer may stop between an empty take
    and the producer's last publish)."""
    mb = native.NativeMailbox((16,), dtype=np.float64)
    n = 2000

    def producer():
        for i in range(1, n + 1):
            mb.publish(np.full(16, float(i)))

    thread = threading.Thread(target=producer)
    thread.start()
    seen, last = 0.0, 0
    while thread.is_alive():
        frame, last_seen = mb.take(last)
        if frame is not None:
            vals = np.unique(frame)
            assert len(vals) == 1 and vals[0] >= seen  # whole, in order
            seen, last = vals[0], last_seen
    thread.join(10)
    assert not thread.is_alive()
    frame, last = mb.take(last)
    if frame is not None:
        assert len(np.unique(frame)) == 1
        seen = frame[0]
    assert seen == n and last == n
