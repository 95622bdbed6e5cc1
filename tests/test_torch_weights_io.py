"""The port's weight readers against the JAX package's, on the CPU: TRT-era
weight blobs (`io/trt_weights.py`, `params_from_trt_blob`), TF v2 tensor
bundles (`io/tf_checkpoint.py`, `load_stereo_params`) on a bundle this file
writes by hand (LevelDB index table with an uncompressed and a
snappy-compressed block, two data shards, fp32 / fp16 / bf16 tensors),
the disparity metrics, and the entry points that load weights
(`stereo_app --checkpoint / --weights <blob>`, `pipeline_app
--stereo-checkpoint`). Every comparison is exact: the readers move bytes."""

import dataclasses
import json
import struct

import numpy as np
import pytest

import jax

from redtail_tpu.io import tf_checkpoint as jtf
from redtail_tpu.io import trt_weights as jtrt
from redtail_tpu.models import STEREO_SPECS as JSPECS
from redtail_tpu.models import stereo as jstereo
from redtail_tpu.utils import metrics as jmetrics

from redtail_tpu_torch.io import (load_checkpoint, read_bin, read_index,
                                  read_trt_weights, sniff_dtype,
                                  write_trt_weights)
from redtail_tpu_torch.io import tf_checkpoint
from redtail_tpu_torch.io.protolite import length_delimited, tag, write_varint
from redtail_tpu_torch.models import (STEREO_SPECS, init_stereo_params,
                                      load_stereo_params, params_from_numpy,
                                      params_from_trt_blob, params_to_numpy,
                                      params_to_trt_blob)
from redtail_tpu_torch.models.stereo import _spec_layer_shapes
from redtail_tpu_torch.utils import metrics
from test_torch_stereo import conditioned


def _tree_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], dict):
            _tree_equal(a[k], b[k])
        else:
            np.testing.assert_array_equal(np.asarray(a[k], np.float32),
                                          np.asarray(b[k], np.float32))


# ------------------------------------------------------------- TRT blobs


@pytest.mark.parametrize("dtype", ["fp32", "fp16"])
def test_trt_blob_round_trips_across_packages(tmp_path, dtype):
    rs = np.random.RandomState(0)
    weights = {"left_scale_shift": rs.randn(3).astype(np.float32),
               "conv1_k": rs.randn(4, 3, 5, 5).astype(np.float32),
               "conv1_b": rs.randn(4).astype(np.float32),
               "empty": np.zeros(0, np.float32)}
    jtrt.write_trt_weights(weights, tmp_path / "jax.bin", dtype=dtype)
    write_trt_weights(weights, tmp_path / "port.bin", dtype=dtype)
    assert (tmp_path / "jax.bin").read_bytes() == \
        (tmp_path / "port.bin").read_bytes()
    got = read_trt_weights(tmp_path / "jax.bin", dtype)
    want = jtrt.read_trt_weights(tmp_path / "jax.bin", dtype)
    assert list(got) == list(want) == list(weights)
    for name in weights:
        assert got[name].dtype == np.float32
        np.testing.assert_array_equal(got[name], want[name])
    assert sniff_dtype(tmp_path / "jax.bin") == \
        jtrt.sniff_dtype(tmp_path / "jax.bin")


def test_sniff_dtype_tells_fp16_from_fp32(tmp_path):
    w = {"left_scale_shift": np.arange(5, dtype=np.float32)}
    for dtype in ("fp32", "fp16"):
        write_trt_weights(w, tmp_path / f"{dtype}.bin", dtype=dtype)
    # an fp32 blob's framing breaks when read as fp16 only where the bytes
    # say so: both packages guess the same either way
    for dtype in ("fp32", "fp16"):
        assert sniff_dtype(tmp_path / f"{dtype}.bin") == \
            jtrt.sniff_dtype(tmp_path / f"{dtype}.bin")
    (tmp_path / "bad.bin").write_bytes(b"no terminator")
    with pytest.raises(ValueError, match="not parseable"):
        sniff_dtype(tmp_path / "bad.bin")


@pytest.mark.parametrize("name", sorted(STEREO_SPECS))
def test_params_from_trt_blob_matches_jax(name):
    spec, jspec = STEREO_SPECS[name], JSPECS[name]
    params = conditioned(init_stereo_params(spec, seed=3))
    blob = params_to_trt_blob(spec, params)
    got = params_from_trt_blob(spec, blob)
    _tree_equal(got, jax.tree.map(np.asarray,
                                  jstereo.params_from_trt_blob(jspec, blob)))
    _tree_equal(got, params)  # the blob's layouts undone exactly


def test_params_from_trt_blob_fp16_blob_serves(tmp_path):
    """An fp16 blob through the file: the port's tree equals JAX's and
    builds the model."""
    spec = dataclasses.replace(STEREO_SPECS["nvtiny"], input_hw=(33, 65),
                               max_disp=8)
    params = conditioned(init_stereo_params(spec, seed=4))
    write_trt_weights(params_to_trt_blob(spec, params), tmp_path / "w.bin",
                      dtype="fp16")
    blob = read_trt_weights(tmp_path / "w.bin", "fp16")
    tree = params_from_trt_blob(spec, blob)
    _tree_equal(tree, jax.tree.map(np.asarray, jstereo.params_from_trt_blob(
        dataclasses.replace(JSPECS["nvtiny"], input_hw=(33, 65), max_disp=8),
        jtrt.read_trt_weights(tmp_path / "w.bin", "fp16"))))
    net = params_from_numpy(spec, tree, device="cpu")
    _tree_equal(params_to_numpy(net), tree)


def test_params_from_trt_blob_checks_bias_size():
    spec = STEREO_SPECS["nvtiny"]
    blob = params_to_trt_blob(spec, init_stereo_params(spec))
    blob["left_conv1_b"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="left_conv1_b"):
        params_from_trt_blob(spec, blob)


# ------------------------------------------------------ TF tensor bundles


def snappy_compress(data: bytes) -> bytes:
    """A small snappy block encoder for the tests: greedy 4-byte matches
    within 2048 bytes as 1-byte-offset copies (length 4..11), farther or
    longer ones as 2-byte-offset copies (up to 64), the rest literals."""
    out = bytearray(write_varint(len(data)))
    last, pos, lit = {}, 0, 0

    def flush(end):
        n = end - lit
        while n:
            step = min(n, 256)
            if step <= 60:
                out.append((step - 1) << 2)
            else:
                out.append(60 << 2)
                out.append(step - 1)
            start = end - n
            out.extend(data[start:start + step])
            n -= step

    while pos + 4 <= len(data):
        key = data[pos:pos + 4]
        cand = last.get(key)
        last[key] = pos
        if cand is None or pos - cand >= 65536:
            pos += 1
            continue
        length = 4
        while (pos + length < len(data) and length < 64
               and data[cand + length] == data[pos + length]):
            length += 1
        flush(pos)
        off = pos - cand
        if length <= 11 and off < 2048:
            out.append(1 | ((length - 4) << 2) | ((off >> 8) << 5))
            out.append(off & 0xFF)
        else:
            out.append(2 | ((length - 1) << 2))
            out.extend(struct.pack("<H", off))
        pos += length
        lit = pos
    flush(len(data))
    return bytes(out)


def _table_block(entries, compress):
    """A LevelDB table block (prefix-compressed keys, one restart) plus its
    trailer: (bytes to append to the file, its handle's size)."""
    body, prev = bytearray(), b""
    for key, value in entries:
        shared = 0
        while (shared < min(len(key), len(prev))
               and key[shared] == prev[shared]):
            shared += 1
        body += (write_varint(shared) + write_varint(len(key) - shared)
                 + write_varint(len(value)) + key[shared:] + value)
        prev = key
    body += struct.pack("<II", 0, 1)  # restart offsets [0], count 1
    raw = snappy_compress(bytes(body)) if compress else bytes(body)
    return raw + bytes([1 if compress else 0]) + b"\0" * 4, len(raw)


_TF_DTYPES = {np.dtype("<f4"): 1, np.dtype("<f2"): 19, "bf16": 14}


def write_bundle(prefix, tensors, shards=2):
    """A TF v2 checkpoint of ``tensors`` (name -> (array, dtype key)):
    tensor i in shard i % shards; the index table's entries in two data
    blocks, the first stored raw and the second snappy-compressed."""
    data = [bytearray() for _ in range(shards)]
    entries = [(b"", length_delimited(1, write_varint(shards)))]  # header
    for i, name in enumerate(sorted(tensors)):
        arr, kind = tensors[name]
        if kind == "bf16":
            raw = (np.asarray(arr, np.float32).view(np.uint32) >> 16
                   ).astype("<u2").tobytes()
        else:
            raw = np.asarray(arr, kind).tobytes()
        shard = i % shards
        dims = b"".join(length_delimited(2, tag(1, 0) + write_varint(d))
                        for d in arr.shape)
        proto = (tag(1, 0) + write_varint(_TF_DTYPES[
            kind if kind == "bf16" else np.dtype(kind)])
            + length_delimited(2, dims)
            + (tag(3, 0) + write_varint(shard) if shard else b"")
            + tag(4, 0) + write_varint(len(data[shard]))
            + tag(5, 0) + write_varint(len(raw)))
        data[shard] += raw
        entries.append((name.encode(), proto))
    half = len(entries) // 2
    table, index = bytearray(), []
    for part, compress in ((entries[:half], False), (entries[half:], True)):
        block, size = _table_block(part, compress)
        index.append((part[-1][0], write_varint(len(table))
                      + write_varint(size)))
        table += block
    meta_off = len(table)
    block, meta_size = _table_block([], False)
    table += block
    idx_off = len(table)
    block, idx_size = _table_block(index, False)
    table += block
    footer = (write_varint(meta_off) + write_varint(meta_size)
              + write_varint(idx_off) + write_varint(idx_size))
    table += footer + b"\0" * (40 - len(footer)) + struct.pack(
        "<Q", 0xDB4775248B80FB57)
    with open(f"{prefix}.index", "wb") as f:
        f.write(table)
    for i, shard in enumerate(data):
        with open(f"{prefix}.data-{i:05d}-of-{shards:05d}", "wb") as f:
            f.write(shard)


def test_snappy_decompress_matches_jax():
    # hand-made tags: literals (short, and a 61-byte one with a length
    # byte), copies with 1-, 2- and 4-byte offsets, an overlapping copy
    lit = bytes(range(61))
    stream = (write_varint(3 + 61 + 8 + 6 + 5 + 7)
              + bytes([(3 - 1) << 2]) + b"abc"
              + bytes([60 << 2, 61 - 1]) + lit
              + bytes([1 | ((8 - 4) << 2), 3])          # copy-1 off 3 len 8
              + bytes([2 | ((6 - 1) << 2)]) + struct.pack("<H", 60)
              + bytes([3 | ((5 - 1) << 2)]) + struct.pack("<I", 70)
              + bytes([1 | ((7 - 4) << 2), 1]))         # overlap: off 1
    got = tf_checkpoint.snappy_decompress(stream)
    assert got == jtf.snappy_decompress(stream)
    assert got[:3] == b"abc" and got[-7:] == got[-8:-7] * 7
    rs = np.random.RandomState(0)
    text = bytes(rs.choice(list(b"redtail stereo "), 5000)) + bytes(
        rs.randint(0, 256, 3000).astype(np.uint8))
    packed = snappy_compress(text)
    assert len(packed) < len(text)
    assert tf_checkpoint.snappy_decompress(packed) == \
        jtf.snappy_decompress(packed) == text
    with pytest.raises(ValueError, match="length"):
        tf_checkpoint.snappy_decompress(write_varint(9) + b"\x08abc")


def test_tf_bundle_reads_like_jax(tmp_path):
    rs = np.random.RandomState(1)
    tensors = {"model/a/w": (rs.randn(2, 3, 4).astype(np.float32), "<f4"),
               "model/a/b": (rs.randn(7).astype(np.float32), "<f2"),
               "model/b/w": (rs.randn(3, 5).astype(np.float32), "bf16"),
               "model/b/scalar": (np.float32(rs.randn()).reshape(()), "<f4"),
               "step": (np.arange(6, dtype=np.float32), "<f4")}
    write_bundle(tmp_path / "ckpt", tensors)
    got = load_checkpoint(tmp_path / "ckpt")
    want = jtf.load_checkpoint(tmp_path / "ckpt")
    assert set(got) == set(want) == set(tensors)
    for name, (arr, kind) in tensors.items():
        assert got[name].dtype == want[name].dtype
        np.testing.assert_array_equal(got[name], want[name])
        if kind == "bf16":  # bf16 bits upcast: the truncated fp32 value
            trunc = (arr.view(np.uint32) & 0xFFFF0000).view(np.float32)
            np.testing.assert_array_equal(got[name], trunc)
        else:
            np.testing.assert_array_equal(got[name], arr.astype(kind))
    assert {k: dataclasses.astuple(v) for k, v in
            read_index(tmp_path / "ckpt").items()} == \
        {k: dataclasses.astuple(v) for k, v in
         jtf.read_index(tmp_path / "ckpt").items()}


def test_tf_bundle_rejects_bad_magic(tmp_path):
    write_bundle(tmp_path / "ckpt", {"x": (np.zeros(2, np.float32), "<f4")},
                 shards=1)
    raw = bytearray((tmp_path / "ckpt.index").read_bytes())
    raw[-1] ^= 0xFF
    (tmp_path / "ckpt.index").write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="magic"):
        load_checkpoint(tmp_path / "ckpt")


def stereo_bundle(prefix, spec, params, kind="<f4"):
    """A stereo param tree as a TF checkpoint with `model/` keys."""
    tensors = {}
    for path, _, _ in _spec_layer_shapes(spec):
        leaf = params
        for p in path.split("/"):
            leaf = leaf[p]
        for var in ("weights", "biases"):
            tensors[f"model/{path}/{var}"] = (np.asarray(leaf[var]), kind)
    write_bundle(prefix, tensors)


@pytest.mark.parametrize("kind", ["<f4", "<f2", "bf16"])
def test_load_stereo_params_matches_jax(tmp_path, kind):
    spec = STEREO_SPECS["resnet18_2d"]
    params = conditioned(init_stereo_params(spec, seed=6))
    stereo_bundle(tmp_path / "ckpt", spec, params, kind)
    got = load_stereo_params(tmp_path / "ckpt")
    _tree_equal(got, jax.tree.map(np.asarray,
                                  jstereo.load_stereo_params(tmp_path /
                                                             "ckpt")))
    if kind == "<f4":
        _tree_equal(got, params)
    params_from_numpy(spec, got, device="cpu")


# ---------------------------------------------------------------- metrics


def test_disparity_errors_match_jax():
    rs = np.random.RandomState(2)
    gt = rs.rand(40, 60).astype(np.float32) * 90
    gt[rs.rand(40, 60) < 0.3] = 0  # sparse ground truth
    pred = gt + rs.randn(40, 60).astype(np.float32) * 4
    for valid in (None, np.ones_like(gt, bool), gt > 40):
        got = metrics.disparity_errors(pred, gt, valid)
        assert got == jmetrics.disparity_errors(pred, gt, valid)
    assert metrics.d1(pred, gt) == jmetrics.d1(pred, gt)
    assert metrics.epe(pred, gt) == jmetrics.epe(pred, gt)
    with pytest.raises(ValueError, match="shape"):
        metrics.disparity_errors(pred[1:], gt)
    with pytest.raises(ValueError, match="no valid"):
        metrics.disparity_errors(pred, np.zeros_like(gt))


# ------------------------------------------------------------ entry points


def _pair(tmp_path, seed):
    cv2 = pytest.importorskip("cv2")
    big = np.random.RandomState(seed).randint(0, 256, (100, 200, 3)).astype(
        np.uint8)
    cv2.imwrite(str(tmp_path / "l.png"), big)
    cv2.imwrite(str(tmp_path / "r.png"), np.roll(big, 3, axis=1))
    return ["--left", str(tmp_path / "l.png"), "--right",
            str(tmp_path / "r.png")]


@pytest.mark.parametrize("source", ["checkpoint", "blob-fp16"])
def test_stereo_app_loads_weights_as_jax(tmp_path, capsys, monkeypatch,
                                         source):
    from redtail_tpu.apps import stereo_app as japp

    from redtail_tpu_torch.apps import stereo_app

    monkeypatch.setenv("REDTAIL_TPU_PACKED3D", "0")
    hw = (33, 65)
    spec = STEREO_SPECS["nvtiny"]
    params = conditioned(init_stereo_params(spec, seed=2))
    if source == "checkpoint":
        stereo_bundle(tmp_path / "ckpt", spec, params)
        load = ["--checkpoint", str(tmp_path / "ckpt")]
    else:
        write_trt_weights(params_to_trt_blob(spec, params), tmp_path / "w.bin",
                          dtype="fp16")
        load = ["--weights", str(tmp_path / "w.bin"), "--weights-dtype",
                "fp16"]
    common = ["nvtiny", "--cpu", "--hw", *map(str, hw), *load,
              *_pair(tmp_path, 5)]
    japp.main(common + ["--out", str(tmp_path / "jax"), "--no-cache"])
    stereo_app.main(common + ["--out", str(tmp_path / "port")])
    capsys.readouterr()
    want = read_bin(tmp_path / "jax.bin")
    got = read_bin(tmp_path / "port.bin")
    assert got.shape == want.shape == hw
    # the same weights on both sides; fp32 summation order, in pixels (as
    # tests/test_torch_stereo3d.py)
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_pipeline_app_serves_a_stereo_checkpoint(tmp_path, capsys,
                                                 monkeypatch):
    """`--stereo-checkpoint` feeds `load_stereo_params` to the stereo
    node: the run serves frames; its weights are the bundle's."""
    from redtail_tpu_torch.apps import pipeline_app
    from redtail_tpu_torch.apps.stereo_app import round_tree
    from redtail_tpu_torch.runtime import nodes
    from test_torch_apps import _stop_after_control_steps

    monkeypatch.setitem(STEREO_SPECS, "resnet18_2d", dataclasses.replace(
        STEREO_SPECS["resnet18_2d"], input_hw=(64, 128), max_disp=8))
    spec = STEREO_SPECS["resnet18_2d"]
    params = conditioned(init_stereo_params(spec, seed=9))
    stereo_bundle(tmp_path / "ckpt", spec, params)
    built = []

    class Recording(nodes.StereoNode):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            built.append(self)

    monkeypatch.setattr(nodes, "StereoNode", Recording)
    _stop_after_control_steps(monkeypatch, 2)
    pipeline_app.main(["--cpu", "--duration", "60", "--yolo-rate", "0",
                       "--stereo-checkpoint", str(tmp_path / "ckpt")])
    s = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert s["frames"]["stereo"] >= 2 and not any(s["errors"].values()), s
    _tree_equal(params_to_numpy(built[0].net),
                round_tree(params, built[0].net.dtype))
