"""Golden-data `.bin` tensor files: int32 rank, int32 dims, fp32 payload
(`redtail_tpu/io/golden.py`; format of the reference's
`stereoDNN/scripts/test_data_generator.py:34-39`). The stereo app writes
its disparity in this format."""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np


def read_bin(path) -> np.ndarray:
    data = Path(path).read_bytes()
    (rank,) = struct.unpack_from("<i", data, 0)
    if not 0 < rank <= 8:
        raise ValueError(f"{path}: implausible rank {rank}")
    dims = struct.unpack_from(f"<{rank}i", data, 4)
    count = int(np.prod(dims))
    arr = np.frombuffer(data, dtype="<f4", offset=4 * (1 + rank), count=count)
    return arr.reshape(dims).copy()


def write_bin(arr: np.ndarray, path) -> None:
    arr = np.asarray(arr, dtype=np.float32)
    with open(path, "wb") as f:
        f.write(struct.pack("<i", arr.ndim))
        for d in arr.shape:
            f.write(struct.pack("<i", d))
        f.write(arr.astype("<f4").reshape(-1).tobytes())
