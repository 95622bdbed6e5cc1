"""Per-stage host timing (`redtail_tpu/runtime/profiler.py`), the
replacement of TensorRT's `IProfiler` tables
(`stereoDNN/sample_app/main.cpp:52-81`), and the port's one kind of trace
span. A stage that ends in a copy to the host (as the serving node's does)
includes the device's time.

`span(name)` marks a region of the program in a `torch.profiler` trace: a
``user_annotation`` event on the trace's own clock, beside the device's
kernels, so a kernel launched inside it can be put down to it. With no
profiler collecting it reads one flag and enters nothing. Every
`StageProfiler` stage is such a span too; the stereo net's stages
(`models/stereo.py`) and the train step's phases (`parallel/training.py`)
are spans alone. This module imports nothing of the port, so the models
can import it."""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext
from typing import Dict, List

from torch.autograd import profiler as _autograd_profiler
from torch.autograd.profiler import record_function

_NO_SPAN = nullcontext()


def tracing() -> bool:
    """Whether a `torch.profiler` is collecting (torch's own flag)."""
    return _autograd_profiler._is_profiler_enabled


def span(name: str):
    """A context manager: ``record_function(name)`` while a profiler
    collects, else a shared no-op."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return record_function(name)


class StageProfiler:
    MAX_SAMPLES = 10_000  # per stage: bounds a long-running node's memory

    def __init__(self):
        self._samples: Dict[str, List[float]] = defaultdict(list)

    @contextmanager
    def stage(self, name: str):
        """Time the block as stage ``name``, inside `span(name)`."""
        t0 = time.perf_counter()
        try:
            with span(name):
                yield
        finally:
            self.record(name, time.perf_counter() - t0)

    def record(self, name: str, seconds: float):
        samples = self._samples[name]
        if len(samples) < self.MAX_SAMPLES:
            samples.append(seconds)

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
