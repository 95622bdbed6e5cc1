"""Minimal protobuf wire-format helpers (`redtail_tpu/io/protolite.py`): no
generated code, no protobuf library.

Used by the TF tensor-bundle reader (`io/tf_checkpoint.py`) and the Caffe
model parsers (`io/caffe.py`). Supports the subset of the wire format
those use: varint, length-delimited, fixed32/64, packed repeated scalars.
"""

from __future__ import annotations

import struct
from typing import Iterator, Tuple, Union

Value = Union[int, bytes]


def read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def write_varint(value: int) -> bytes:
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def fields(buf: bytes) -> Iterator[Tuple[int, int, Value]]:
    """Yield (field_number, wire_type, value) over a serialized message."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            val, pos = read_varint(buf, pos)
        elif wire == 2:
            ln, pos = read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:
            val = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
        elif wire == 1:
            val = struct.unpack_from("<Q", buf, pos)[0]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def tag(field: int, wire: int) -> bytes:
    return write_varint((field << 3) | wire)


def length_delimited(field: int, payload: bytes) -> bytes:
    return tag(field, 2) + write_varint(len(payload)) + payload
