"""One run of one cell: set-up, the measured window, the per-layer reading
of a traced window, the check against the reference, and the result line.

Everything a cell is made of is found by name: the cell in
`BENCHMARK.json`, its configuration file (the entry's ``file``), its
traffic (`traffic/<traffic>.json`), the module of the traffic's ``kind``
(`kinds/<kind>.py`: ``inputs`` makes the pool from the seed, ``drive``
sets up the timed path, runs the window and reads the check's numbers),
its limits (`limits/<cell>.json`) and each per-layer metric's reader
(`metrics/<metric>.py`, or the file of the longest dotted prefix of the
metric's name that has one: a ``read(run)`` that returns a number or None,
and may name the host ``REGIONS`` whose device time it reads).
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import torch

from portbench.harness import check, data, port
from portbench.harness.trace import WINDOW, TraceSummary, summarize

ROOT = Path(__file__).resolve().parents[2]


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _read_json(path: Path) -> dict:
    return json.loads(path.read_text())


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s `BENCHMARK.json` and its files."""
    bench = _read_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: "
                       f"{sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", ())
                 or ("workloads" not in m and m["moves"] in moved)]
    return Cell(name, _read_json(root / conf["file"]),
                _read_json(root / "portbench" / "traffic"
                           / f"{w['traffic']}.json"),
                _read_json(root / "portbench" / "limits" / f"{name}.json"),
                e2e, per_layer)


def metric_file(name: str, root: Path = ROOT) -> Path:
    """`portbench/metrics/<name>.py`, or where there is none the file of
    the longest dotted prefix of ``name`` that has one: `mfu.py` reads
    `mfu.serve` and `mfu.train`."""
    parts = name.split(".")
    for k in range(len(parts), 0, -1):
        path = root / "portbench" / "metrics" / f"{'.'.join(parts[:k])}.py"
        if path.is_file():
            return path
    raise FileNotFoundError(f"no reader for the metric {name!r}")


def metric_reader(name: str, root: Path = ROOT):
    """The module that reads the metric ``name``."""
    path = metric_file(name, root)
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + path.stem.replace(".", "_").replace("-", "_"),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def kind_module(kind: str):
    """The module `portbench/kinds/<kind>.py` that drives a traffic of
    that kind."""
    return importlib.import_module(f"portbench.kinds.{kind}")


@dataclass
class Run:
    """What the per-layer readers read of one run."""

    cell: Cell
    kind: str                    # the traffic's kind
    window_s: float
    work: int                    # frames completed, or steps
    batch: int
    hw: tuple
    passes: int                  # forward passes of nominal work a unit
    stages: Dict[str, float] = field(default_factory=dict)
    trace: Optional[TraceSummary] = None
    peak_window_bytes: int = 0


class Outcome:
    """What one run yields for the result line, with its set-up phases."""

    def __init__(self, t_start: float):
        self.marks = [("start", t_start)]
        self.e2e: Dict[str, float] = {}
        self.run: Optional[Run] = None
        self.numbers: Dict[str, float] = {}
        self.attempted = 0
        self.memory_peak_bytes = 0
        self.notes: List[str] = []

    def mark(self, phase: str) -> None:
        """The end of a set-up phase."""
        self.marks.append((phase, time.perf_counter()))

    def phases(self) -> str:
        return ", ".join(f"{b[0]} {b[1] - a[1]:.3f}"
                         for a, b in zip(self.marks, self.marks[1:]))


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def peak(device) -> int:
    return torch.cuda.max_memory_allocated(device) \
        if torch.device(device).type == "cuda" else 0


def reset_peak(device):
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def free(device):
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


class Window:
    """The measured window: a `torch.profiler` trace of it when traced, and
    the `WINDOW` span that marks it in the trace."""

    def __init__(self, traced: bool, device):
        self.traced = traced
        self.cuda = torch.device(device).type == "cuda"

    def __enter__(self):
        if self.traced:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if self.cuda else [])
            self.prof = profile(activities=acts)
            self.prof.__enter__()
        self.span = torch.profiler.record_function(WINDOW)
        self.span.__enter__()
        return self

    def __exit__(self, *exc):
        self.span.__exit__(*exc)
        if self.traced:
            self.prof.__exit__(*exc)

    def summary(self, regions) -> Optional[TraceSummary]:
        if not self.traced:
            return None
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            return summarize(path, regions)
        finally:
            os.unlink(path)


def run(name: str, seed: int, seconds: float, traced: bool, *,
        root: Path = ROOT, **kw) -> dict:
    """One run of cell ``name`` of ``root``'s `BENCHMARK.json`."""
    return run_cell(load_cell(name, root), seed, seconds, traced, **kw)


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, *,
             device="cuda", t_start: Optional[float] = None,
             hooks: Optional[dict] = None) -> dict:
    """One run of ``cell``; returns the result line's fields, with
    ``notes``, ``numbers`` and ``checks`` for the caller to print."""
    t_start = time.perf_counter() if t_start is None else t_start
    hooks = hooks or {}
    readers = {m["name"]: metric_reader(m["name"])
               for m in cell.per_layer} if traced else {}
    regions = sorted({r for mod in readers.values()
                      for r in getattr(mod, "REGIONS", ())})
    out = Outcome(t_start)
    spec = port.port_spec(cell.config)
    drive = kind_module(cell.traffic["kind"])
    out.mark("imports")
    g = data.generator(seed, device)
    tree = data.make_weights(cell.config, g, device)
    load = drive.inputs(cell.config, cell.traffic, g, device)
    out.mark("inputs")
    drive.drive(cell, spec, tree, load, seed, seconds, traced, device,
                t_start, regions, hooks, out)
    out.notes.append(f"set-up phases (s): {out.phases()}")
    ok, checks = check.judge(out.numbers, cell.limits)
    metrics = {}
    if traced:
        for m in cell.per_layer:
            value = readers[m["name"]].read(out.run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": out.e2e[m["name"]],
                                  "unit": m["unit"]}
    failed = sum(c["value"] > c["limit"] or c["value"] != c["value"]
                 for c in checks.values())
    result = {"correct": ok, "attempted": out.attempted,
              "failed": failed, "metrics": metrics,
              "memory_peak_bytes": out.memory_peak_bytes,
              "notes": out.notes, "numbers": out.numbers, "checks": checks}
    tr = out.run.trace
    if tr is not None:
        result["busy_s"], result["window_s"] = tr.busy_s, tr.window_s
        result["breakdown"] = {"device_ops": tr.top_ops(),
                               "idle_gaps": tr.top_gaps()}
    return result
