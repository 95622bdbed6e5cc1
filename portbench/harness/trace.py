"""Reduction of a `torch.profiler` chrome trace to what the per-layer
metrics read: the device's busy time (the union of kernel, copy and memset
intervals, not a sum), the device operations inside the traced window, the
device time of the kernels launched inside a named op's region on the host,
the device time of kernels by name, and the idle gaps named by what the
driving host thread was doing.

The window is the host annotation `WINDOW` that the harness records around
its timed loop; device intervals are clipped to it.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

WINDOW = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
NAME_CHARS = 120


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    device_ops: int
    by_name: Dict[str, Tuple[int, float]]        # kernel -> (count, seconds)
    regions: Dict[str, Tuple[int, float]]        # op -> (calls, seconds)
    idle_by_host: Dict[str, float] = field(default_factory=dict)

    def kernel_seconds(self, fragment: str) -> Tuple[int, float]:
        """(count, seconds) of the kernels whose name holds ``fragment``."""
        n = s = 0
        for name, (c, sec) in self.by_name.items():
            if fragment in name:
                n, s = n + c, s + sec
        return n, s

    def top_ops(self, k: int = 10) -> List[list]:
        top = sorted(self.by_name.items(), key=lambda kv: -kv[1][1])[:k]
        return [[name[:NAME_CHARS], sec] for name, (_c, sec) in top]

    def top_gaps(self, k: int = 10) -> List[list]:
        top = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:k]
        return [[name[:NAME_CHARS], sec] for name, sec in top]


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1] = (merged[-1][0], b)
        else:
            merged.append((a, b))
    return merged


def summarize(path, region_ops=()) -> TraceSummary:
    """The summary of the chrome trace at ``path``; ``region_ops``: op
    names whose regions' kernels are attributed to them."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    windows = [e for e in events if e.get("name") == WINDOW
               and e.get("cat") == "user_annotation"]
    if len(windows) != 1:
        raise ValueError(f"the trace holds {len(windows)} '{WINDOW}' spans")
    win = windows[0]
    w0, w1 = float(win["ts"]), float(win["ts"]) + float(win["dur"])
    main = (win.get("pid"), win.get("tid"))
    device, launch_ts = [], {}
    host_main = []
    regions = {op: [] for op in region_ops}
    for e in events:
        cat = e.get("cat")
        if e.get("ph") != "X":
            continue
        if cat in DEVICE_CATS:
            a = float(e["ts"])
            b = a + float(e.get("dur", 0.0))
            if b > w0 and a < w1:
                device.append((max(a, w0), min(b, w1), e))
        elif cat in HOST_CATS:
            args = e.get("args") or {}
            if cat in ("cuda_runtime", "cuda_driver") \
                    and "correlation" in args:
                launch_ts[args["correlation"]] = float(e["ts"])
            if e.get("name") in regions and w0 <= float(e["ts"]) <= w1:
                regions[e["name"]].append(
                    (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
            if (e.get("pid"), e.get("tid")) == main and e is not win:
                host_main.append((float(e["ts"]), float(e["ts"])
                                  + float(e.get("dur", 0.0)), e["name"]))
    by_name: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    for a, b, e in device:
        entry = by_name[e["name"]]
        entry[0] += 1
        entry[1] += (b - a) * 1e-6
    busy = _union([(a, b) for a, b, _ in device])
    busy_s = sum(b - a for a, b in busy) * 1e-6
    region_time = {}
    for op, spans in regions.items():
        spans.sort()
        starts = [s for s, _ in spans]
        sec = 0.0
        for a, b, e in device:
            t = launch_ts.get((e.get("args") or {}).get("correlation"))
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and spans[i][0] <= t <= spans[i][1]:
                sec += (b - a) * 1e-6
        region_time[op] = (len(spans), sec)
    gaps = []
    prev = w0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if w1 > prev:
        gaps.append((prev, w1))
    return TraceSummary(
        window_s=(w1 - w0) * 1e-6, busy_s=busy_s, device_ops=len(device),
        by_name={k: (v[0], v[1]) for k, v in by_name.items()},
        regions=region_time, idle_by_host=_name_gaps(gaps, host_main))


def _name_gaps(gaps, host) -> Dict[str, float]:
    """Seconds of device idle by the innermost host span of the driving
    thread around each gap's midpoint ('host: none' where there is none)."""
    host.sort(key=lambda h: (h[0], -h[1]))
    out: Dict[str, float] = defaultdict(float)
    marks = sorted(((a + b) / 2, b - a) for a, b in gaps)
    stack: List[Tuple[float, float, str]] = []
    i = 0
    for mid, length in marks:
        while i < len(host) and host[i][0] <= mid:
            while stack and stack[-1][1] <= host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        name = stack[-1][2] if stack else "host: none"
        out[name] += length * 1e-6
    return dict(out)
