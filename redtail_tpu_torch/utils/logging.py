"""Logging setup with per-module verbosity (`redtail_tpu/utils/logging.py`).

The reference configured per-node log levels through
`ros/configs/rosconsole.config`; here one call configures the root
`redtail_tpu_torch` logger plus per-subsystem overrides, e.g.::

    setup_logging("info", {"redtail_tpu_torch.telemetry": "debug"})
"""

from __future__ import annotations

import logging
import sys
from typing import Dict, Optional

_FORMAT = "%(asctime)s [%(levelname).1s] %(name)s: %(message)s"


def setup_logging(level: str = "info",
                  module_levels: Optional[Dict[str, str]] = None,
                  stream=None) -> logging.Logger:
    root = logging.getLogger("redtail_tpu_torch")
    root.setLevel(getattr(logging, level.upper()))
    if not root.handlers:
        handler = logging.StreamHandler(stream or sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT))
        root.addHandler(handler)
    for name, lvl in (module_levels or {}).items():
        logging.getLogger(name).setLevel(getattr(logging, lvl.upper()))
    return root
