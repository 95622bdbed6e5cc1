"""The reader of `deconv3d_roofline` (`metrics/deconv3d_roofline.py`): the
3D decoder's least bytes, worked out by hand from the published layer
shapes at 321x1025, batch 1, against the reader's; its share from the op's
regions; nothing without a trace or a region, as a program without the op
has none."""

import pytest

from portbench.harness import cell as C
from portbench.harness.trace import TraceSummary

MB = 1e6


def _layer(y, c_in, out, c_out, skip=True):
    """Bytes of one transposed conv: y (D, H, W) x c_in and the output (and
    skip) (D, H, W) x c_out in bf16, its 3x3x3 bf16 weights, fp32 bias."""
    vol = lambda s, c: s[0] * s[1] * s[2] * c  # noqa: E731
    return 2 * (vol(y, c_in) + (2 if skip else 1) * vol(out, c_out)
                + 27 * c_in * c_out) + 4 * c_out


# NVSmall at 321x1025, D 48: the encoder's (48, 161, 513) x 32 -> (24,
# 81, 257) x 64 -> (12, 41, 129) x 128; ResNet-18 3D, D 68: (68, 161,
# 513) x 32 ... (5, 11, 33) x 128
NVSMALL = [_layer((12, 41, 129), 128, (24, 81, 257), 64),
           _layer((24, 81, 257), 64, (48, 161, 513), 32),
           _layer((48, 161, 513), 32, (96, 321, 1025), 1, skip=False)]
RESNET18_3D = [_layer((5, 11, 33), 128, (9, 21, 65), 64),
               _layer((9, 21, 65), 64, (17, 41, 129), 64),
               _layer((17, 41, 129), 64, (34, 81, 257), 64),
               _layer((34, 81, 257), 64, (68, 161, 513), 32),
               _layer((68, 161, 513), 32, (136, 321, 1025), 1, skip=False)]


def _reader():
    return C.metric_reader("deconv3d_roofline")


def _run(cell, trace=None, work=10):
    return C.Run(C.load_cell(cell), "stream", 1.0, work, 1, (321, 1025), 1,
                 {}, trace)


def _trace(regions):
    return TraceSummary(window_s=1.0, busy_s=0.9, device_ops=100,
                        by_name={}, regions=regions)


@pytest.mark.parametrize("cell,want,table", [
    ("nvsmall.serve", NVSMALL, (144.6, 571.5, 316.9)),
    ("resnet18_3d.serve", RESNET18_3D, (4.1, 24.8, 192.9, 809.6, 448.9))])
def test_bytes_are_the_decoders_least_traffic(cell, want, table):
    got = _reader().layer_bytes(C.load_cell(cell).config, (321, 1025))
    assert [b for _, b in got] == want
    assert [round(b / MB, 1) for b in want] == list(table)
    total = {"nvsmall.serve": 1033, "resnet18_3d.serve": 1480}[cell]
    assert round(sum(want) / MB) == total


def test_share_of_the_regions():
    """Three regions a frame at their least time each: 100%; at twice the
    device time, 50%."""
    bound_s = sum(NVSMALL) / 3.35e12
    reader = _reader()
    op = reader.REGIONS[0]
    assert reader.read(_run("nvsmall.serve", _trace(
        {op: (30, 10 * bound_s)}))) == pytest.approx(100.0)
    assert reader.read(_run("nvsmall.serve", _trace(
        {op: (30, 20 * bound_s)}))) == pytest.approx(50.0)


def test_nothing_without_a_trace_or_a_region():
    reader = _reader()
    assert reader.read(_run("nvsmall.serve")) is None
    assert reader.read(_run("nvsmall.serve", _trace({}))) is None
    assert reader.read(_run("nvsmall.serve", _trace(
        {reader.REGIONS[0]: (0, 0.0)}))) is None
    assert reader.read(_run("resnet18_3d.serve", _trace(
        {reader.REGIONS[0]: (5, 0.001)}), work=0)) is None


def test_listed_for_the_fused_serving_cells():
    for cell in ("nvsmall.serve", "resnet18_3d.serve"):
        assert "deconv3d_roofline" in {
            m["name"] for m in C.load_cell(cell).per_layer}
    for cell in ("nvsmall.serve.packed", "resnet18_3d.cam30",
                 "resnet18_3d.train"):
        assert "deconv3d_roofline" not in {
            m["name"] for m in C.load_cell(cell).per_layer}
