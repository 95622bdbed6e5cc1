"""The TRT-era weight blob (`redtail_tpu/io/trt_weights.py`): repeated
[name\\0][uint32 count][raw values].

The reference serializes model weights in this format
(`stereoDNN/scripts/tensorrt_model_builder.py:52-60` writer,
`stereoDNN/sample_app/main.cpp:111-134` reader). Values are fp32 or fp16
depending on the export. Shapes are not stored: they come from the model
spec (`models/stereo.py:params_from_trt_blob`), as the generated C++
carried them.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Dict, Literal

import numpy as np

DType = Literal["fp32", "fp16"]


def read_trt_weights(path, dtype: DType = "fp32") -> Dict[str, np.ndarray]:
    """Parse a weight blob into name -> flat fp32 array (fp16 upcast)."""
    data = Path(path).read_bytes()
    np_dtype = np.dtype("<f2") if dtype == "fp16" else np.dtype("<f4")
    out: Dict[str, np.ndarray] = {}
    pos = 0
    n = len(data)
    while pos < n:
        end = data.index(b"\0", pos)
        name = data[pos:end].decode()
        pos = end + 1
        (count,) = struct.unpack_from("<I", data, pos)
        pos += 4
        arr = np.frombuffer(data, dtype=np_dtype, count=count, offset=pos)
        pos += count * np_dtype.itemsize
        out[name] = arr.astype(np.float32)
    return out


def write_trt_weights(weights: Dict[str, np.ndarray], path,
                      dtype: DType = "fp32") -> None:
    np_dtype = np.dtype("<f2") if dtype == "fp16" else np.dtype("<f4")
    with open(path, "wb") as f:
        for name, arr in weights.items():
            f.write(name.encode() + b"\0")
            flat = np.asarray(arr).reshape(-1).astype(np_dtype)
            f.write(struct.pack("<I", flat.size))
            f.write(flat.tobytes())


def sniff_dtype(path, names_hint=("left_scale_shift",)) -> DType:
    """Guess fp32 vs fp16 by parsing consistency: the wrong item size
    derails the name\\0 framing almost at once."""
    for dt in ("fp32", "fp16"):
        try:
            read_trt_weights(path, dt)
            return dt  # type: ignore[return-value]
        except (ValueError, IndexError, struct.error):
            continue
    raise ValueError(f"{path}: not parseable as fp32 or fp16 weight blob")
