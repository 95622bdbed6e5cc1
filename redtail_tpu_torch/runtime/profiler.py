"""Per-stage host timing (`redtail_tpu/runtime/profiler.py`), the
replacement of TensorRT's `IProfiler` tables
(`stereoDNN/sample_app/main.cpp:52-81`). A stage that ends in a copy to the
host (as the serving node's does) includes the device's time."""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, List


class StageProfiler:
    MAX_SAMPLES = 10_000  # per stage: bounds a long-running node's memory

    def __init__(self):
        self._samples: Dict[str, List[float]] = defaultdict(list)

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            samples = self._samples[name]
            if len(samples) < self.MAX_SAMPLES:
                samples.append(dt)

    def record(self, name: str, seconds: float):
        self._samples[name].append(seconds)

    def stats(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, xs in self._samples.items():
            if not xs:
                continue
            s = sorted(xs)
            n = len(s)
            out[name] = {
                "count": n,
                "mean_ms": 1e3 * sum(s) / n,
                "p50_ms": 1e3 * s[n // 2],
                "p99_ms": 1e3 * s[min(n - 1, int(n * 0.99))],
                "max_ms": 1e3 * s[-1],
            }
        return out

    def report(self) -> str:
        """Stage-times table in the reference's `printLayerTimes` style."""
        lines = [f"{'stage':<28}{'count':>8}{'mean ms':>10}{'p50 ms':>10}"
                 f"{'p99 ms':>10}{'max ms':>10}"]
        for name, st in sorted(self.stats().items()):
            lines.append(
                f"{name:<28}{st['count']:>8}{st['mean_ms']:>10.3f}"
                f"{st['p50_ms']:>10.3f}{st['p99_ms']:>10.3f}"
                f"{st['max_ms']:>10.3f}")
        return "\n".join(lines)

    def reset(self):
        self._samples.clear()
