"""The readers of the program's spans (`metrics/node.*`, `net.*`,
`train.*`) on a hand-made chrome trace: device time a unit of the kernels
launched inside a span, on any host thread, and nothing of the kernels
launched outside one; the node's stages from `run.stages`; nothing where
the program has no such span or stage, as an older program has not."""

import json

import pytest

from portbench.harness import cell as C
from portbench.harness.trace import WINDOW, summarize

NET = [f"net.{s}_ms" for s in ("towers", "volume", "enc3d", "dec3d",
                               "head")]
TRAIN = [f"train.{s}_ms" for s in ("forward", "backward", "optimizer")]
MAIN, AUTOGRAD = 1, 2  # host threads: the driving one, the backward's


def _span(name, ts, dur, tid=MAIN):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur, "pid": 1, "tid": tid}


def _launch(corr, ts, tid=MAIN):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "ts": ts, "dur": 5, "pid": 1, "tid": tid,
            "args": {"correlation": corr}}


def _kernel(corr, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": f"k{corr}", "ts": ts, "dur": dur,
            "pid": 0, "tid": 7, "args": {"correlation": corr}}


def _trace(tmp_path):
    """Times in us: two `stereo/enc3d` spans and one `train/backward` in a
    1000 us window; kernels launched in them (one from another thread, as
    the backward's are) and outside them."""
    events = [
        _span(WINDOW, 0, 1000),
        _span("stereo/enc3d", 100, 100), _span("stereo/enc3d", 500, 100),
        _span("train/backward", 700, 200),
        _launch(1, 150), _kernel(1, 160, 30),                 # in enc3d
        _launch(2, 550), _kernel(2, 560, 20),                 # in enc3d
        _launch(3, 300), _kernel(3, 310, 40),                 # outside
        _launch(6, 610), _kernel(6, 630, 50),                 # just after
        _launch(4, 750, tid=AUTOGRAD), _kernel(4, 760, 50),   # in backward
        _launch(5, 950), _kernel(5, 955, 10, "gpu_memcpy"),   # outside
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return path


def _run(trace=None, work=2, stages=None):
    cell = C.load_cell("resnet18_3d.serve")
    return C.Run(cell, "stream", 1e-3, work, 1, (321, 1025), 1,
                 stages or {}, trace)


def _readers(names):
    return {n: C.metric_reader(n) for n in names}


def test_region_readers_read_the_kernels_launched_in_their_spans(tmp_path):
    readers = _readers(NET + TRAIN)
    regions = sorted({r for m in readers.values() for r in m.REGIONS})
    assert regions == sorted([f"stereo/{n[4:-3]}" for n in NET]
                             + [f"train/{n[6:-3]}" for n in TRAIN])
    tr = summarize(_trace(tmp_path), regions)
    assert tr.regions["stereo/enc3d"] == (2, pytest.approx(50e-6))
    assert tr.regions["train/backward"] == (1, pytest.approx(50e-6))
    # the idle gaps centred inside the backward (680-760, 810-955 us) are
    # named by its span
    assert tr.idle_by_host["train/backward"] == pytest.approx(225e-6)
    run = _run(tr, work=2)
    got = {n: m.read(run) for n, m in readers.items()}
    # device ms a unit: (30 + 20) us over 2 frames; 50 us over 2 steps
    assert got.pop("net.enc3d_ms") == pytest.approx(0.025)
    assert got.pop("train.backward_ms") == pytest.approx(0.025)
    assert set(got.values()) == {None}


@pytest.mark.parametrize("name", NET + TRAIN)
def test_region_readers_read_nothing_without_a_trace_or_work(tmp_path,
                                                             name):
    reader = C.metric_reader(name)
    tr = summarize(_trace(tmp_path), reader.REGIONS)
    assert reader.read(_run(None)) is None
    assert reader.read(_run(tr, work=0)) is None


def test_node_stage_readers():
    readers = _readers(["node.upload_ms", "node.enqueue_ms"])
    stages = {"stereo/resnet18/upload": 0.4, "stereo/resnet18/enqueue": 9.5,
              "stereo/resnet18/dispatch": 10.0}
    run = _run(stages=stages)
    assert readers["node.upload_ms"].read(run) == 0.4
    assert readers["node.enqueue_ms"].read(run) == 9.5
    # a node without the two stages
    older = _run(stages={"stereo/resnet18/dispatch": 10.0})
    assert [m.read(older) for m in readers.values()] == [None, None]
