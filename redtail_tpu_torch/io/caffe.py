"""Caffe model I/O (`redtail_tpu/io/caffe.py`): prototxt (text-proto)
parsing and caffemodel (binary NetParameter) weight extraction, with no
Caffe and no protobuf library.

The parsed graph is executed by `redtail_tpu_torch.models.caffe_net`. The
text parser handles the generic `key: value` / `block { ... }` protobuf text
format; every field is stored as a list (protobuf repeated semantics), with
`Msg.get/get_all` accessors.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

from redtail_tpu_torch.io import protolite


class Msg:
    """A parsed text-proto message: field name -> list of values."""

    __slots__ = ("fields",)

    def __init__(self):
        self.fields: Dict[str, List[Any]] = {}

    def add(self, key: str, value: Any) -> None:
        self.fields.setdefault(key, []).append(value)

    def get(self, key: str, default: Any = None) -> Any:
        vals = self.fields.get(key)
        return vals[0] if vals else default

    def get_all(self, key: str) -> List[Any]:
        return self.fields.get(key, [])

    def __contains__(self, key: str) -> bool:
        return key in self.fields

    def __repr__(self):
        return f"Msg({list(self.fields)})"


def _tokenize(text: str):
    for raw_line in text.splitlines():
        line = raw_line.split("#", 1)[0].strip()
        if not line:
            continue
        # spaces around the structural characters; quoted strings kept whole
        out = []
        i = 0
        while i < len(line):
            c = line[i]
            if c == '"':
                j = line.index('"', i + 1)
                out.append(line[i:j + 1])
                i = j + 1
            elif c in "{}:":
                out.append(c)
                i += 1
            elif c.isspace():
                i += 1
            else:
                j = i
                while j < len(line) and not line[j].isspace() \
                        and line[j] not in '{}:"':
                    j += 1
                out.append(line[i:j])
                i = j
        yield from out


def _coerce(tok: str):
    if tok.startswith('"'):
        return tok[1:-1]
    if tok in ("true", "True"):
        return True
    if tok in ("false", "False"):
        return False
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        return tok  # enum identifier (e.g. MAX, AVE, SUM)


def parse_prototxt(text: str) -> Msg:
    tokens = list(_tokenize(text))
    root = Msg()
    stack = [root]
    i = 0
    n = len(tokens)
    while i < n:
        tok = tokens[i]
        if tok == "}":
            stack.pop()
            i += 1
            continue
        key = tok
        i += 1
        if i < n and tokens[i] == ":":
            i += 1
            stack[-1].add(key, _coerce(tokens[i]))
            i += 1
        elif i < n and tokens[i] == "{":
            child = Msg()
            stack[-1].add(key, child)
            stack.append(child)
            i += 1
        else:
            raise ValueError(f"parse error near token {i}: {key!r}")
    if len(stack) != 1:
        raise ValueError("unbalanced braces in prototxt")
    return root


def load_prototxt(path) -> Msg:
    return parse_prototxt(Path(path).read_text())


# --------------------------------------------------------------- caffemodel

# NetParameter: layer = 100 (new) / layers = 2 (legacy V1)
# LayerParameter: name=1, type=2(string new)/(enum legacy), blobs=7
# BlobProto: num,channels,height,width = 1..4 (legacy), data=5 (packed float),
#            shape=7 (BlobShape: dim=1 repeated int64)


def _parse_blob(buf: bytes) -> np.ndarray:
    shape: Optional[List[int]] = None
    legacy = [0, 0, 0, 0]
    data = b""
    for field, wire, val in protolite.fields(buf):
        if field == 7 and wire == 2:  # BlobShape
            shape = []
            for f2, w2, v2 in protolite.fields(val):
                if f2 == 1:
                    if w2 == 2:  # packed
                        pos = 0
                        while pos < len(v2):
                            d, pos = protolite.read_varint(v2, pos)
                            shape.append(d)
                    else:
                        shape.append(v2)
        elif field == 5 and wire == 2:  # packed float data
            data = val
        elif 1 <= field <= 4 and wire == 0:
            legacy[field - 1] = val
    arr = np.frombuffer(data, dtype="<f4").copy()
    if shape is None:
        shape = [d for d in legacy if d] or [arr.size]
    if int(np.prod(shape)) == arr.size:
        arr = arr.reshape(shape)
    return arr


def parse_caffemodel(data: bytes) -> Dict[str, List[np.ndarray]]:
    """Extract layer name -> list of weight blobs from a .caffemodel."""
    out: Dict[str, List[np.ndarray]] = {}
    for field, wire, val in protolite.fields(data):
        if field in (100, 2) and wire == 2:  # layer / legacy layers
            name = None
            blobs: List[np.ndarray] = []
            for f2, w2, v2 in protolite.fields(val):
                if f2 == 1 and w2 == 2:
                    name = v2.decode()
                elif f2 == 7 and w2 == 2:
                    blobs.append(_parse_blob(v2))
            if name is not None and blobs:
                out[name] = blobs
    return out


def load_caffemodel(path) -> Dict[str, List[np.ndarray]]:
    return parse_caffemodel(Path(path).read_bytes())


def write_caffemodel(layers: Dict[str, List[np.ndarray]]) -> bytes:
    """Serialize name -> blobs as a minimal (new-style) NetParameter,
    readable by `parse_caffemodel` and by Caffe itself."""
    out = bytearray()
    for name, blobs in layers.items():
        layer = bytearray()
        layer += protolite.length_delimited(1, name.encode())
        for blob in blobs:
            blob = np.asarray(blob, dtype=np.float32)
            shape_payload = bytearray()
            for d in blob.shape:
                shape_payload += protolite.tag(1, 0)
                shape_payload += protolite.write_varint(d)
            blob_msg = protolite.length_delimited(7, bytes(shape_payload))
            blob_msg += protolite.length_delimited(
                5, blob.astype("<f4").tobytes())
            layer += protolite.length_delimited(7, blob_msg)
        out += protolite.length_delimited(100, bytes(layer))
    return bytes(out)
