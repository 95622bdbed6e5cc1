"""Streaming runtime (`redtail_tpu/runtime/__init__.py`): the in-process
node graph replacing the reference's ROS pub/sub topology (camera -> DNN
nodes -> controller, `ros/packages/caffe_ros/launch/everything.launch`),
the serving nodes, stage timing, the persistent compilation cache and
serialized engines (`cache.py`, `engine_builder.py`), the per-layer
profiler (`layer_profiler.py`), frame sources and visualization.

The serving nodes import the models, so they load at first use
(`__getattr__`): a process that only runs an engine
(`cache.load_engine`) imports no model code."""

from redtail_tpu_torch.runtime.cache import enable_compilation_cache
from redtail_tpu_torch.runtime.graph import (
    ApproxTimeSync,
    Node,
    NodeGraph,
    Stamped,
    Topic,
)
from redtail_tpu_torch.runtime.profiler import StageProfiler
from redtail_tpu_torch.runtime.sources import FrameSource, ImageFileSource
from redtail_tpu_torch.runtime.viz import disp_to_color, make_mosaic

_NODES = ("StereoNode", "TrailNetNode", "VizNode", "YoloNode", "tap_stage")


def __getattr__(name):
    if name in _NODES:
        from redtail_tpu_torch.runtime import nodes
        return getattr(nodes, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "Topic",
    "Node",
    "NodeGraph",
    "ApproxTimeSync",
    "Stamped",
    "StageProfiler",
    "enable_compilation_cache",
    "FrameSource",
    "ImageFileSource",
    "disp_to_color",
    "make_mosaic",
    "StereoNode",
    "TrailNetNode",
    "VizNode",
    "YoloNode",
    "tap_stage",
]
