"""ctypes binding of the C++ host runtime (`native/redtail_native.cpp`), the
port's own copy of `redtail_tpu/native.py`.

The library is built at first use with ``g++ -O3 -std=c++17 -shared -fPIC``
into `redtail_tpu_torch/build/` (listed in `.gitignore`), under a file name
that carries a hash of the source, the compiler, the flags and the host
(`library_path`), so an edited source is rebuilt and a stale or foreign
library is never loaded. `build()` raises when the compiler fails;
`load()` returns ``None`` where there is no compiler or source, and every
caller then takes its numpy path.

`pack_s2d` counts which path served each call (``pack_s2d.native_calls``,
``pack_s2d.numpy_calls``), so a serving path can show that it took the
native pack and that the fallback did not hide a failed build.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import subprocess
import sys
import threading
from pathlib import Path
from typing import Optional

import numpy as np

PACKAGE = Path(__file__).resolve().parent
SOURCE = PACKAGE.parent / "native" / "redtail_native.cpp"
BUILD = PACKAGE / "build"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")


def _cxx() -> str:
    return os.environ.get("CXX", "g++")


def library_path() -> Path:
    """The library's file, named by a hash of the source, the compiler's
    ``--version``, the flags and the host's architecture and C library: a
    library built by another compiler or for another host is never
    loaded. Raises `OSError` or `RuntimeError` where the compiler does
    not run."""
    version = subprocess.run([_cxx(), "--version"], capture_output=True,
                             text=True)
    if version.returncode:
        raise RuntimeError(f"{_cxx()} --version exited {version.returncode}")
    digest = hashlib.sha1(SOURCE.read_bytes())
    for part in (version.stdout, " ".join(CXX_FLAGS), platform.machine(),
                 " ".join(platform.libc_ver())):
        digest.update(part.encode())
    return BUILD / f"libredtail_native-{digest.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the library if it is missing; returns its path. Raises with
    the compiler's output when the build fails."""
    path = library_path()
    if path.exists():
        return path
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(
        f"{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cxx = _cxx()
    proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native runtime build failed ({cxx} exited "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)  # atomic: safe against a concurrent build
    return path


@functools.lru_cache(maxsize=None)
def load() -> Optional[ctypes.CDLL]:
    """The library, built first if needed (once per process); ``None``
    where it cannot be built here (no compiler, no source)."""
    try:
        path = build()
    except (OSError, RuntimeError):
        return None
    lib = ctypes.CDLL(str(path))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.rn_preprocess_bilinear.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, f32p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float]
    lib.rn_preprocess_bilinear.restype = None
    lib.rn_preprocess_area.argtypes = lib.rn_preprocess_bilinear.argtypes
    lib.rn_preprocess_area.restype = None
    lib.rn_hwc_to_chw.argtypes = [f32p, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int, f32p]
    lib.rn_hwc_to_chw.restype = None
    lib.rn_pack_s2d.argtypes = [u8p, ctypes.c_int, ctypes.c_int,
                                ctypes.c_int, u8p, ctypes.c_int]
    lib.rn_pack_s2d.restype = None
    lib.rn_mailbox_create.restype = ctypes.c_void_p
    lib.rn_mailbox_create.argtypes = [ctypes.c_size_t]
    lib.rn_mailbox_destroy.restype = None
    lib.rn_mailbox_destroy.argtypes = [ctypes.c_void_p]
    lib.rn_mailbox_publish.restype = ctypes.c_uint64
    lib.rn_mailbox_publish.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.rn_mailbox_take.restype = ctypes.c_uint64
    lib.rn_mailbox_take.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_uint64]
    return lib


def available() -> bool:
    return load() is not None


def _require():
    lib = load()
    if lib is None:
        raise RuntimeError("the native runtime is not available: it builds "
                           f"from {SOURCE.name} with g++ at first use")
    return lib


def _u8p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _f32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _frame(img_u8: np.ndarray) -> np.ndarray:
    img_u8 = np.ascontiguousarray(img_u8, np.uint8)
    if img_u8.ndim != 3:
        raise ValueError(f"expected one (H, W, C) frame, got {img_u8.shape}")
    return img_u8


def preprocess_bilinear(img_u8: np.ndarray, dst_hw, *, swap_rb=True,
                        scale=1.0 / 255.0, shift=0.0) -> np.ndarray:
    """(H, W, C) uint8 -> (h, w, C) float32: bilinear resize, optional
    R <-> B swap, x * scale + shift, in one pass."""
    lib = _require()
    img_u8 = _frame(img_u8)
    h, w, c = img_u8.shape
    dh, dw = dst_hw
    out = np.empty((dh, dw, c), np.float32)
    lib.rn_preprocess_bilinear(_u8p(img_u8), h, w, c, _f32p(out), dh, dw,
                               int(swap_rb), scale, shift)
    return out


def preprocess_area(img_u8: np.ndarray, dst_hw, *, swap_rb=True,
                    scale=1.0 / 255.0, shift=0.0) -> np.ndarray:
    """As `preprocess_bilinear`, with an area (box) resize."""
    lib = _require()
    img_u8 = _frame(img_u8)
    h, w, c = img_u8.shape
    dh, dw = dst_hw
    out = np.empty((dh, dw, c), np.float32)
    lib.rn_preprocess_area(_u8p(img_u8), h, w, c, _f32p(out), dh, dw,
                           int(swap_rb), scale, shift)
    return out


def pack_s2d(x_u8: np.ndarray, *, swap_rb: bool = True) -> np.ndarray:
    """Serving-ingest pack: uint8 (..., H, W, C) frames -> uint8
    space-to-depth(2) packed (..., ceil(H/2), ceil(W/2), 4C), optionally
    BGR -> RGB. Bit-identical to `ops.space_to_depth.space_to_depth2_np`
    on the flipped channels either way: the native single pass where the
    library is built, numpy for C > 16 (the kernel leaves its output
    unwritten there) and where it is not."""
    x_u8 = np.asarray(x_u8)
    lib = load()
    if lib is None or x_u8.dtype != np.uint8 or x_u8.shape[-1] > 16:
        from redtail_tpu_torch.ops.space_to_depth import space_to_depth2_np
        pack_s2d.numpy_calls += 1
        return space_to_depth2_np(x_u8[..., ::-1] if swap_rb else x_u8)
    lead = x_u8.shape[:-3]
    h, w, c = x_u8.shape[-3:]
    swap_native = swap_rb and c == 3
    if swap_rb and not swap_native:  # the kernel swaps 3 channels only
        x_u8 = x_u8[..., ::-1]
    frames = np.ascontiguousarray(x_u8).reshape((-1, h, w, c))
    hp, wp = -(-h // 2), -(-w // 2)
    out = np.empty((frames.shape[0], hp, wp, 4 * c), np.uint8)
    for i in range(frames.shape[0]):
        lib.rn_pack_s2d(_u8p(frames[i]), h, w, c, _u8p(out[i]),
                        int(swap_native))
    pack_s2d.native_calls += 1
    return out.reshape(lead + (hp, wp, 4 * c))


pack_s2d.native_calls = 0
pack_s2d.numpy_calls = 0


def hwc_to_chw(img: np.ndarray) -> np.ndarray:
    lib = _require()
    img = np.ascontiguousarray(img, np.float32)
    if img.ndim != 3:
        raise ValueError(f"expected an (H, W, C) image, got {img.shape}")
    h, w, c = img.shape
    out = np.empty((c, h, w), np.float32)
    lib.rn_hwc_to_chw(_f32p(img), h, w, c, _f32p(out))
    return out


class NativeMailbox:
    """Lock-free single-producer single-consumer latest-wins frame mailbox
    (the native core of a `runtime.graph.Topic`)."""

    def __init__(self, frame_shape, dtype=np.uint8):
        self._lib = _require()
        self.frame_shape = tuple(frame_shape)
        self.dtype = np.dtype(dtype)
        self._nbytes = int(np.prod(self.frame_shape)) * self.dtype.itemsize
        self._mb = self._lib.rn_mailbox_create(self._nbytes)

    def publish(self, frame: np.ndarray) -> int:
        frame = np.ascontiguousarray(frame, self.dtype)
        if frame.nbytes != self._nbytes:
            raise ValueError(f"frame of {frame.nbytes} bytes for a mailbox "
                             f"of {self._nbytes}")
        return int(self._lib.rn_mailbox_publish(
            self._mb, frame.ctypes.data_as(ctypes.c_void_p)))

    def take(self, last_seq: int = 0):
        """(frame, seq) of the newest frame if newer than ``last_seq``,
        else (None, last_seq)."""
        out = np.empty(self.frame_shape, self.dtype)
        seq = int(self._lib.rn_mailbox_take(
            self._mb, out.ctypes.data_as(ctypes.c_void_p), last_seq))
        if seq == 0:
            return None, last_seq
        return out, seq

    def close(self) -> None:
        if getattr(self, "_mb", None):
            self._lib.rn_mailbox_destroy(self._mb)
            self._mb = None

    def __del__(self):
        self.close()


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "build":
        print(build())
    else:
        print("available:", available())
