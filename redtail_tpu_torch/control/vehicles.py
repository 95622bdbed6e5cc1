"""Vehicle backends (`px4_controller.h:58-111` polymorphism):

- ``Drone``: forwards the goto pose to a setpoint sink (the reference
  publishes `/mavros/setpoint_position/local`, `px4_controller.cpp:35-41`).
- ``APMRoverRC``: converts (linear, angular) controls to RC override
  channel values with trim/deadzone offsets (`px4_controller.cpp:109-129`).
- ``APMRoverWaypoint``: pose passthrough with APM's GUIDED mode name.

Sinks are plain callables so the same backends drive the simulator, logs,
or a real MAVLink bridge.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional


class Vehicle:
    offboard_mode_name = "OFFBOARD"
    name = "vehicle"

    def execute_command(self, ctl, goto_pose, linear, angular, has_command):
        raise NotImplementedError


class Drone(Vehicle):
    name = "drone"

    def __init__(self, setpoint_sink: Optional[Callable] = None):
        self.setpoint_sink = setpoint_sink
        self.history: List = []

    def execute_command(self, ctl, goto_pose, linear, angular, has_command):
        self.history.append(goto_pose.copy())
        if self.setpoint_sink is not None:
            self.setpoint_sink(goto_pose)


RC_NOCHANGE = 65535  # mavros OverrideRCIn::CHAN_NOCHANGE


class APMRoverRC(Vehicle):
    name = "apmrover_rc"
    offboard_mode_name = "MANUAL"

    def __init__(self, rc_sink: Optional[Callable] = None, *,
                 linear_speed_scale: float = 1.0,
                 turn_angle_scale: float = 1.0,
                 steer_trim: int = 1500, steer_dz: int = 0,
                 throttle_trim: int = 1500, throttle_dz: int = 0):
        self.rc_sink = rc_sink
        self.linear_speed_scale = linear_speed_scale
        self.turn_angle_scale = turn_angle_scale
        self.steer_trim = steer_trim
        self.steer_dz = steer_dz
        self.throttle_trim = throttle_trim
        self.throttle_dz = throttle_dz
        self.history: List[List[int]] = []

    def execute_command(self, ctl, goto_pose, linear, angular, has_command):
        channels = [RC_NOCHANGE] * 8
        steer_delta = int(self.turn_angle_scale * angular)
        steer_dz = int(math.copysign(self.steer_dz, steer_delta)) \
            if steer_delta != 0 else 0
        channels[0] = self.steer_trim + steer_dz + steer_delta
        throttle_delta = int(self.linear_speed_scale * ctl.cfg.linear_speed
                             * linear)
        throttle_dz = int(math.copysign(self.throttle_dz, throttle_delta)) \
            if throttle_delta != 0 else 0
        channels[2] = self.throttle_trim + throttle_dz + throttle_delta
        if has_command:
            self.history.append(channels)
            if self.rc_sink is not None:
                self.rc_sink(channels)


class APMRoverWaypoint(Vehicle):
    name = "apmrover_waypoint"
    offboard_mode_name = "GUIDED"

    def __init__(self, setpoint_sink: Optional[Callable] = None):
        self.setpoint_sink = setpoint_sink
        self.history: List = []

    def execute_command(self, ctl, goto_pose, linear, angular, has_command):
        self.history.append(goto_pose.copy())
        if self.setpoint_sink is not None:
            self.setpoint_sink(goto_pose)
