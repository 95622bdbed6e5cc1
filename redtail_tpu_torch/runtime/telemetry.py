"""Runtime telemetry: the 1 Hz status line the reference controller
logged (`px4_controller.cpp:157-175`: pose + "AI score" = fraction of
DNN-issued commands), generalized to any set of probes."""

from __future__ import annotations

import json
import logging
import threading
import time
from typing import Callable, Dict, Optional

logger = logging.getLogger("redtail_tpu_torch.telemetry")


class Telemetry:
    """Periodically samples named probes and emits one JSON line each."""

    def __init__(self, interval_sec: float = 1.0,
                 sink: Optional[Callable[[dict], None]] = None):
        self.interval = interval_sec
        self.probes: Dict[str, Callable[[], object]] = {}
        self.sink = sink or (lambda rec: logger.info(json.dumps(rec)))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.records: list = []

    def add_probe(self, name: str, fn: Callable[[], object]) -> None:
        self.probes[name] = fn

    def add_controller(self, ctl) -> None:
        """Standard controller probes (pose, state, ai_score)."""
        self.add_probe("pose", lambda: [round(float(v), 3) for v in
                                        ctl.current_pose.position])
        self.add_probe("state", lambda: ctl.state.name)
        self.add_probe("ai_score", lambda: round(ctl.ai_score, 3))
        self.add_probe("use_dnn", lambda: ctl.use_dnn)

    def sample(self) -> dict:
        rec = {"t": time.time()}
        for name, fn in self.probes.items():
            try:
                rec[name] = fn()
            except Exception as e:  # probes must never kill telemetry
                rec[name] = f"<err {type(e).__name__}>"
        self.records.append(rec)
        self.sink(rec)
        return rec

    def _run(self):
        while not self._stop.wait(self.interval):
            self.sample()

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 2.0):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
