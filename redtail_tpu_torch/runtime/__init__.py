"""Streaming runtime (`redtail_tpu/runtime/__init__.py`): the in-process
node graph replacing the reference's ROS pub/sub topology (camera -> DNN
nodes -> controller, `ros/packages/caffe_ros/launch/everything.launch`),
the serving nodes, stage timing, frame sources and visualization. XLA's
compilation cache has no counterpart: the CUDA kernels are cached by the
hash of their source (`kernels/_build.py`)."""

from redtail_tpu_torch.runtime.graph import (
    ApproxTimeSync,
    Node,
    NodeGraph,
    Stamped,
    Topic,
)
from redtail_tpu_torch.runtime.nodes import (
    StereoNode,
    TrailNetNode,
    VizNode,
    YoloNode,
    tap_stage,
)
from redtail_tpu_torch.runtime.profiler import StageProfiler
from redtail_tpu_torch.runtime.sources import FrameSource, ImageFileSource
from redtail_tpu_torch.runtime.viz import disp_to_color, make_mosaic

__all__ = [
    "Topic",
    "Node",
    "NodeGraph",
    "ApproxTimeSync",
    "Stamped",
    "StageProfiler",
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
