"""The load generator: it reads a traffic file (`traffic/<name>.json`) and
drives the timed path for ``seconds``.

Two kinds of traffic:

- ``stream``: stereo pairs from the pool, in pool order, handed to the
  serving node one call at a time. With ``rate_hz`` null, in a closed
  loop: the next pair goes as soon as the call returns, and a pair's
  latency runs from the call that submits it. With a rate, in an open
  loop: pair i is due at i / rate_hz after the start (late pairs go as
  soon as the node is free), and its latency runs from when it was due.
  Either ends at the call that returns its disparity (with frames in
  flight, a later call). Frames in flight at the close are not counted.
- ``train_steps``: the pool's batches in turn through the train step; the
  window ends in a device synchronize.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch


@dataclass
class StreamWindow:
    seconds: float
    submitted: int
    latencies: List[float]
    kept: List[Tuple[int, np.ndarray]] = field(default_factory=list)

    @property
    def completed(self) -> int:
        return len(self.latencies)


def stream(call: Callable, results: Callable, left: np.ndarray,
           right: np.ndarray, seconds: float, *,
           rate_hz: Optional[float],
           keep: int, rng: np.random.Generator,
           clock=time.perf_counter) -> StreamWindow:
    """Drive ``call(left, right)`` for ``seconds``; ``results(out)`` lists
    the disparities a call returned, oldest first. ``rate_hz``: None for
    a closed loop, else the fixed rate pairs are due at. ``keep``: a uniform
    sample (reservoir, from ``rng``) of the completed frames, as (pool
    index, disparity)."""
    pool = len(left)
    pending: deque = deque()  # (time the frame was due, pool index)
    latencies: List[float] = []
    kept: List[Tuple[int, np.ndarray]] = []
    t0 = clock()
    end = t0 + seconds
    i = 0
    now = t0
    while now < end:
        if rate_hz is None:
            due = clock()
        else:
            due = t0 + i / rate_hz
            _wait_until(due, clock)
        k = i % pool
        pending.append((due, k))
        out = call(left[k], right[k])
        now = clock()
        for disp in results(out):
            start, idx = pending.popleft()
            latencies.append(now - start)
            c = len(latencies) - 1
            if c < keep:
                kept.append((idx, disp))
            else:
                j = int(rng.integers(0, c + 1))
                if j < keep:
                    kept[j] = (idx, disp)
        i += 1
    return StreamWindow(now - t0, i, latencies, kept)


def _wait_until(due: float, clock) -> None:
    """Sleep until about a millisecond before ``due``, then spin: a frame
    goes out on time, not a scheduler tick late."""
    while (left := due - clock()) > 0:
        if left > 2e-3:
            time.sleep(left - 1e-3)


@dataclass
class StepWindow:
    seconds: float
    steps: int
    last_loss: Optional[torch.Tensor]


def train_steps(step: Callable, batches, seconds: float, start: int, *,
                sync: Callable, clock=time.perf_counter) -> StepWindow:
    """Drive ``step(batch)`` over the pool from batch ``start`` for
    ``seconds`` of host time, then ``sync()``: the window runs from its
    start to the end of that synchronize."""
    sync()
    t0 = clock()
    n = 0
    loss = None
    while clock() - t0 < seconds:
        loss = step(batches[(start + n) % len(batches)])
        n += 1
    sync()
    return StepWindow(clock() - t0, n, loss)
