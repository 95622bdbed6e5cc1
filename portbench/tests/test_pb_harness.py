"""The harness end to end on the CPU at a small size: the result line's
keys, the per-layer line, and the refusal without a card."""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.harness import cell as C
from portbench.tests.tiny import tiny_cell

ROOT = Path(__file__).resolve().parents[2]


def load_run_module():
    spec = importlib.util.spec_from_file_location(
        "pb_run_cli", ROOT / "portbench" / "run.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def drive(monkeypatch, capsys, name, trace):
    """run.py's main with the look for a card skipped and the cell run on
    the CPU at a test's size; returns (rc, last stdout line, stderr)."""
    run = load_run_module()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "cpu")
    monkeypatch.setattr(run, "nvidia_smi", lambda: "none")
    small = tiny_cell(name)
    real = C.run_cell
    monkeypatch.setattr(C, "run", lambda n, seed, sec, traced, **kw: real(
        small, seed, sec, traced, device="cpu", t_start=kw["t_start"]))
    rc = run.main(["--workload", name, "--seed", str(2 ** 31 + 5),
                   "--seconds", "0.5", "--trace", str(trace)])
    out = capsys.readouterr()
    return rc, out.out.strip().splitlines()[-1], out.err


@pytest.mark.parametrize("name", ["nvsmall.serve", "nvsmall.serve.packed",
                                  "resnet18_3d.train"])
@pytest.mark.parametrize("trace", [0, 1])
def test_last_line(monkeypatch, capsys, name, trace):
    rc, last, err = drive(monkeypatch, capsys, name, trace)
    assert rc == 0
    line = json.loads(last)
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    cell = C.load_cell(name)
    want = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert set(line["metrics"]) <= want
    if not trace:
        assert set(line["metrics"]) == want
    else:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    for key, c in line["checks"].items():
        assert c["value"] <= c["limit"]
        assert f"check {key} " in err
    assert err.strip().splitlines()[-1].startswith("check ")
    assert line["device"]["count"] == 1


def test_refuses_without_a_card(tmp_path):
    env = {"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
           "HOME": str(tmp_path), "TMPDIR": str(tmp_path)}
    proc = subprocess.run(
        [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
         "nvsmall.serve", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert proc.returncode != 0
    assert "{" not in proc.stdout
    assert "NVIDIA card" in proc.stderr


def _one_in_flight(clock_now, call_s):
    """A node that takes ``call_s`` a call and hands back the previous
    call's frame, as a node with one frame in flight does."""
    held = []

    def call(left, right):
        clock_now[0] += call_s
        out = held.pop() if held else None
        held.append(left)
        return out
    return call


@pytest.mark.parametrize("rate_hz", [None, 200.0])
def test_stream_loop(rate_hz):
    """Closed loop: each pair goes when the call before returns, and its
    latency is two calls. At a fixed rate above what the node sustains,
    the backlog grows and so do the latencies."""
    from portbench.harness import traffic
    now = [0.0]
    left = np.arange(5, dtype=np.float32)[:, None] + 100
    w = traffic.stream(_one_in_flight(now, 1 / 64),
                       lambda out: [] if out is None else [out], left, left,
                       10 / 64, rate_hz=rate_hz, keep=3,
                       rng=np.random.default_rng(0), clock=lambda: now[0])
    assert w.submitted == 10 and w.completed == 9
    if rate_hz is None:
        assert w.latencies == pytest.approx([2 / 64] * 9)
    else:
        assert np.all(np.diff(w.latencies) > 0.004)
    assert len(w.kept) == 3
    for idx, got in w.kept:
        assert got == left[idx]
