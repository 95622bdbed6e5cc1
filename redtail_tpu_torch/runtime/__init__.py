"""Serving runtime: nodes and stage timing."""

from redtail_tpu_torch.runtime.nodes import StereoNode
from redtail_tpu_torch.runtime.profiler import StageProfiler

__all__ = ["StageProfiler", "StereoNode"]
