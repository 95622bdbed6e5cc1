"""TrailNet-probability debug pose — the `redtail_debug` node
(`ros/packages/redtail_debug/src/redtail_debug_node.cpp:59-73`): converts
the 6-channel TrailNet output into a pose for visualization, with
angle = pi/2 * (p_left - p_right) and lateral offset = p3 - p5."""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


@dataclass
class DebugPose:
    yaw: float        # radians; + = trail bends left
    y_offset: float   # lateral offset proxy in [-1, 1]

    def as_quaternion(self) -> np.ndarray:
        from redtail_tpu_torch.control.geometry import yaw_quat
        return yaw_quat(self.yaw)


def probs_to_debug_pose(probs) -> DebugPose:
    p = np.asarray(probs, np.float32).reshape(-1)
    yaw = (math.pi / 2.0) * (float(p[0]) - float(p[2]))
    y_offset = float(p[3]) - float(p[5]) if p.size >= 6 else 0.0
    return DebugPose(yaw=yaw, y_offset=y_offset)
