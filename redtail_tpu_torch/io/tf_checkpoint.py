"""Reader for TensorFlow v2 checkpoints ("tensor bundles") in numpy alone
(`redtail_tpu/io/tf_checkpoint.py`).

The reference's conversion toolchain (`stereoDNN/scripts/model_builder.py`)
needed a TF 1.x runtime to open its shipped checkpoints. This reader needs
nothing but numpy: it parses the LevelDB-table `.index` file (blocks with
prefix-compressed keys, restart arrays, optional snappy compression, the
48-byte footer with magic 0xdb4775248b80fb57) and the `BundleEntryProto`
records inside (`io/protolite.py`), then slices the tensors out of the
`.data-NNNNN-of-MMMMM` shard files; bf16 tensors are upcast to fp32.
`tests/test_torch_weights_io.py` holds it against the JAX package's reader
on a bundle the test writes by hand.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from redtail_tpu_torch.io.protolite import fields as _proto_fields
from redtail_tpu_torch.io.protolite import read_varint as _read_varint

_TABLE_MAGIC = 0xDB4775248B80FB57

# TF DataType enum -> numpy dtype (the subset a model checkpoint can contain).
_DTYPES = {
    1: np.dtype("<f4"),    # DT_FLOAT
    2: np.dtype("<f8"),    # DT_DOUBLE
    3: np.dtype("<i4"),    # DT_INT32
    4: np.dtype("<u1"),    # DT_UINT8
    5: np.dtype("<i2"),    # DT_INT16
    6: np.dtype("<i1"),    # DT_INT8
    9: np.dtype("<i8"),    # DT_INT64
    10: np.dtype("bool"),  # DT_BOOL
    14: np.dtype("<u2"),   # DT_BFLOAT16 (raw bits)
    19: np.dtype("<f2"),   # DT_HALF
    22: np.dtype("<u4"),   # DT_UINT32
    23: np.dtype("<u8"),   # DT_UINT64
}


# ----------------------------------------------------------------- snappy


def snappy_decompress(data: bytes) -> bytes:
    """Minimal snappy block-format decompressor (no framing)."""
    out_len, pos = _read_varint(data, 0)
    out = bytearray()
    n = len(data)
    while pos < n:
        tag = data[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:  # literal
            ln = tag >> 2
            if ln >= 60:
                extra = ln - 59
                ln = int.from_bytes(data[pos:pos + extra], "little")
                pos += extra
            ln += 1
            out += data[pos:pos + ln]
            pos += ln
        else:
            if kind == 1:  # copy, 1-byte offset
                ln = ((tag >> 2) & 0x7) + 4
                offset = ((tag >> 5) << 8) | data[pos]
                pos += 1
            elif kind == 2:  # copy, 2-byte offset
                ln = (tag >> 2) + 1
                offset = int.from_bytes(data[pos:pos + 2], "little")
                pos += 2
            else:  # copy, 4-byte offset
                ln = (tag >> 2) + 1
                offset = int.from_bytes(data[pos:pos + 4], "little")
                pos += 4
            start = len(out) - offset
            if start < 0:
                raise ValueError("snappy: bad copy offset")
            for _ in range(ln):  # may overlap; byte-by-byte is the semantics
                out.append(out[start])
                start += 1
    if len(out) != out_len:
        raise ValueError("snappy: length mismatch")
    return bytes(out)


# ----------------------------------------------------------- table reading


def _read_block(data: bytes, offset: int, size: int) -> bytes:
    block = data[offset:offset + size]
    ctype = data[offset + size]
    if ctype == 0:
        return block
    if ctype == 1:
        return snappy_decompress(block)
    raise ValueError(f"unknown block compression {ctype}")


def _iter_block_entries(block: bytes):
    """Yield (key, value) from a prefix-compressed table block."""
    (num_restarts,) = struct.unpack_from("<I", block, len(block) - 4)
    data_end = len(block) - 4 * (num_restarts + 1)
    pos = 0
    key = b""
    while pos < data_end:
        shared, pos = _read_varint(block, pos)
        non_shared, pos = _read_varint(block, pos)
        value_len, pos = _read_varint(block, pos)
        key = key[:shared] + block[pos:pos + non_shared]
        pos += non_shared
        value = block[pos:pos + value_len]
        pos += value_len
        yield key, value


def _decode_block_handle(buf: bytes, pos: int = 0) -> Tuple[int, int, int]:
    offset, pos = _read_varint(buf, pos)
    size, pos = _read_varint(buf, pos)
    return offset, size, pos


@dataclass(frozen=True)
class BundleEntry:
    dtype: np.dtype
    shape: Tuple[int, ...]
    shard_id: int
    offset: int
    size: int


def _parse_shape(buf: bytes) -> Tuple[int, ...]:
    dims: List[int] = []
    for field, _wire, val in _proto_fields(buf):
        if field == 2:  # Dim
            size = 0
            for f2, _w2, v2 in _proto_fields(val):
                if f2 == 1:
                    # zigzag is not used here; sizes are plain varints
                    size = v2
            dims.append(size)
    return tuple(dims)


def _parse_entry(buf: bytes) -> BundleEntry:
    dtype = np.dtype("<f4")
    shape: Tuple[int, ...] = ()
    shard_id = 0
    offset = 0
    size = 0
    for field, _wire, val in _proto_fields(buf):
        if field == 1:
            dtype = _DTYPES[val]
        elif field == 2:
            shape = _parse_shape(val)
        elif field == 3:
            shard_id = val
        elif field == 4:
            offset = val
        elif field == 5:
            size = val
    return BundleEntry(dtype, shape, shard_id, offset, size)


def read_index(prefix) -> Dict[str, BundleEntry]:
    """Parse `<prefix>.index` into name -> BundleEntry."""
    data = Path(str(prefix) + ".index").read_bytes()
    magic = struct.unpack_from("<Q", data, len(data) - 8)[0]
    if magic != _TABLE_MAGIC:
        raise ValueError(f"{prefix}.index: bad table magic {magic:#x}")
    footer = data[len(data) - 48:]
    _mi_off, _mi_sz, pos = _decode_block_handle(footer)
    idx_off, idx_sz, _ = _decode_block_handle(footer, pos)
    index_block = _read_block(data, idx_off, idx_sz)

    entries: Dict[str, BundleEntry] = {}
    for _key, handle in _iter_block_entries(index_block):
        off, sz, _ = _decode_block_handle(handle)
        for key, value in _iter_block_entries(_read_block(data, off, sz)):
            name = key.decode()
            if name == "":
                continue  # BundleHeaderProto
            entries[name] = _parse_entry(value)
    return entries


def _shard_path(prefix, shard_id: int, num_shards: int) -> Path:
    return Path(f"{prefix}.data-{shard_id:05d}-of-{num_shards:05d}")


def load_checkpoint(prefix) -> Dict[str, np.ndarray]:
    """Load every tensor of a TF checkpoint into name -> ndarray.

    bfloat16 tensors are upcast to float32 (numpy has no native bf16).
    """
    prefix = str(prefix)
    entries = read_index(prefix)
    num_shards = max((e.shard_id for e in entries.values()), default=0) + 1
    shards: Dict[int, bytes] = {}
    out: Dict[str, np.ndarray] = {}
    for name, e in sorted(entries.items()):
        if e.shard_id not in shards:
            shards[e.shard_id] = _shard_path(
                prefix, e.shard_id, num_shards).read_bytes()
        raw = shards[e.shard_id][e.offset:e.offset + e.size]
        count = int(np.prod(e.shape)) if e.shape else 1
        arr = np.frombuffer(raw, dtype=e.dtype, count=count).reshape(e.shape)
        if e.dtype == np.dtype("<u2"):  # bf16 bits -> f32
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
        out[name] = arr.copy()
    return out
