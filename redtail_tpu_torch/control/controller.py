"""The navigation controller state machine and control laws.

Behavioral port of `PX4Controller`
(`ros/packages/px4_controller/src/px4_controller.cpp`):

- state machine Noop -> Armed -> Takeoff -> Navigating (`spin:731-752`)
- DNN 6-probability -> turn angle law (`computeDNNControl:351-381`):
  `turn = dnn_turn_angle*(p_right_view - p_left_view)
        + dnn_lateralcorr_angle*(p_right_side - p_left_side)`,
  clamped to ±90°, exponentially filtered, mapped to unit-circle
  (cos, sin) linear/angular controls
- waypoint = pose + R * (lin, ang, 0) * speed (`computeNextWaypoint`)
- joystick-over-DNN priority, DNN on/off buttons, yaw-in-place and
  altitude nudges (`spin:770-868`, `joystickCallback:178-236`)
- object-stop interlock: class 14 ("person"), prob >= limit, box height
  > 0.5 * 180 -> kill DNN control (`objDnnCallback:280-349`)
- offboard guard: if the FCU leaves OFFBOARD, freeze the goto pose
  (`spin:763-768`)

The ROS plumbing is replaced by plain method calls: feed inputs via
`on_trailnet`/`on_objects`/`on_joystick`/`set_pose`/`set_fcu_state`, call
`step()` at the spin rate (20 Hz reference default), and the selected
vehicle backend receives `execute_command(...)`.
"""

from __future__ import annotations

import enum
import math
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from redtail_tpu_torch.control.geometry import (
    quat_from_two_vectors,
    quat_identity,
    quat_rotate,
)

DNN_FRAME_HEIGHT = 180          # `px4_controller.h:116`
CLASS_OBJ_STOP = 14             # person (`px4_controller.h:117`)
OBJ_STOP_HEIGHT_RATIO = 0.5     # `px4_controller.h:118`


class ControllerState(enum.Enum):
    NOOP = 0
    ARMED = 1
    TAKEOFF = 2
    NAVIGATING = 3


@dataclass
class Pose:
    position: np.ndarray = field(default_factory=lambda: np.zeros(3))
    orientation: np.ndarray = field(default_factory=quat_identity)

    def copy(self) -> "Pose":
        return Pose(self.position.copy(), self.orientation.copy())


@dataclass
class FcuState:
    mode: str = ""
    armed: bool = False


@dataclass
class JoyCommand:
    linear: float = 0.0
    angular: float = 0.0
    yaw: float = 0.0
    altitude: float = 0.0
    dnn_on: bool = False
    dnn_off: bool = False
    dnn_left: bool = False   # debug: simulate full-right probability
    dnn_right: bool = False


@dataclass
class ControllerConfig:
    spin_rate_hz: float = 20.0             # must exceed 2 Hz for PX4
    linear_speed: float = 2.0
    takeoff_altitude_gain: float = 1.5
    position_tolerance: float = 0.3
    dnn_turn_angle: float = 10.0           # degrees
    dnn_lateralcorr_angle: float = 10.0    # degrees
    direction_filter_innov_coeff: float = 1.0
    joystick_deadzone: float = 0.05
    obj_det_limit: float = 0.3             # -1 disables the object stop
    altitude_nudge: float = 0.03           # `spin:816`
    yaw_rate_scale: float = 0.3            # `spin:824`
    offboard_mode_name: str = "OFFBOARD"


class Controller:
    def __init__(self, vehicle, config: Optional[ControllerConfig] = None):
        self.vehicle = vehicle
        self.cfg = config or ControllerConfig()
        self.state = ControllerState.NOOP
        self.fcu = FcuState()
        self.current_pose = Pose()
        self.goto_pose = Pose()
        self.altitude = 0.0
        self.is_moving = False
        self.use_dnn = False
        # control inputs (latest-wins, like the reference's fields)
        self._joy = JoyCommand()
        self._got_joy = False
        self._dnn_linear = 0.0
        self._dnn_angular = 0.0
        self._got_dnn = False
        self._turn_angle = 0.0   # filtered, radians
        self.dnn_commands = 0
        self.joy_commands = 0
        self.stop_events = 0

    # ------------------------------------------------------------ inputs

    def set_pose(self, pose: Pose):
        self.current_pose = pose.copy()

    def set_fcu_state(self, state: FcuState):
        self.fcu = state

    def _init_autopilot(self):
        self._turn_angle = 0.0
        self.dnn_commands = 0
        self.joy_commands = 0

    def on_joystick(self, joy: JoyCommand):
        dz = self.cfg.joystick_deadzone

        def dead(v):
            return v if abs(v) > dz else 0.0

        self._joy = JoyCommand(dead(joy.linear), dead(joy.angular),
                               dead(joy.yaw), dead(joy.altitude))
        if joy.dnn_left:   # debug buttons simulate extreme DNN outputs
            lin, ang = self._compute_dnn_control([0, 0, 1, 0, 1, 0])
            self._joy.linear, self._joy.angular = lin, ang
        elif joy.dnn_right:
            lin, ang = self._compute_dnn_control([1, 0, 0, 0, 1, 0])
            self._joy.linear, self._joy.angular = lin, ang
        if not self.use_dnn and joy.dnn_on:
            self.use_dnn = True
            self._init_autopilot()
        elif self.use_dnn and joy.dnn_off:
            self.use_dnn = False
        self._got_joy = True

    def on_trailnet(self, probs):
        """TrailNet 6 (or 3) probabilities -> new DNN control values."""
        probs = np.asarray(probs, float).reshape(-1)
        if not self.use_dnn:
            self._got_dnn = False
            return
        p = np.array([probs[0], probs[1], probs[2], 0.0, 1.0, 0.0])
        if probs.size >= 6:
            p[3:6] = probs[3:6]
        self._dnn_linear, self._dnn_angular = self._compute_dnn_control(p)
        self._got_dnn = True

    def on_objects(self, detections):
        """(n, 6) [label, prob, x, y, w, h] matrix -> stop interlock."""
        if self.cfg.obj_det_limit < 0 or not self.use_dnn:
            return
        for row in np.asarray(detections, float).reshape(-1, 6):
            label, prob, _x, _y, _w, h = row
            if int(label) == CLASS_OBJ_STOP and prob >= self.cfg.obj_det_limit \
                    and h / DNN_FRAME_HEIGHT > OBJ_STOP_HEIGHT_RATIO:
                self.use_dnn = False
                self._joy = JoyCommand()
                self._dnn_linear = self._dnn_angular = 0.0
                self.stop_events += 1
                return

    # ------------------------------------------------------- control laws

    def _compute_dnn_control(self, probs):
        p = np.asarray(probs, float)
        view_sum = p[0] + p[1] + p[2]
        side_sum = p[3] + p[4] + p[5]
        left_view, right_view = p[0] / view_sum, p[2] / view_sum
        left_side, right_side = p[3] / side_sum, p[5] / side_sum
        turn_deg = self.cfg.dnn_turn_angle * (right_view - left_view) \
            + self.cfg.dnn_lateralcorr_angle * (right_side - left_side)
        turn_deg = max(-90.0, min(turn_deg, 90.0))
        turn_rad = math.radians(turn_deg)
        a = self.cfg.direction_filter_innov_coeff
        self._turn_angle = self._turn_angle * (1 - a) + turn_rad * a
        return math.cos(self._turn_angle), math.sin(self._turn_angle)

    def compute_next_waypoint(self, pose: Pose, linear: float, angular: float,
                              speed: float) -> np.ndarray:
        movement = np.array([linear, angular, 0.0]) * speed
        return pose.position + quat_rotate(pose.orientation, movement)

    @staticmethod
    def rotation_to(position: np.ndarray, target: np.ndarray) -> np.ndarray:
        direction = np.array([target[0] - position[0],
                              target[1] - position[1], 0.0])
        return quat_from_two_vectors(np.array([1.0, 0.0, 0.0]), direction)

    # ------------------------------------------------------------- spin

    def arm(self):
        """Arm + enter the state machine (the MAVROS arming handshake is
        the vehicle/FCU bridge's job; simulation sets armed directly)."""
        self.goto_pose = self.current_pose.copy()
        self.state = ControllerState.ARMED

    def step(self):
        """One spin-loop iteration (`spin:731-868`)."""
        cfg = self.cfg
        linear = angular = yaw = alt = 0.0
        has_command = False
        pose = self.current_pose

        if self.state == ControllerState.ARMED:
            self.goto_pose.position = self.goto_pose.position \
                + np.array([0.0, 0.0, cfg.takeoff_altitude_gain])
            self.state = ControllerState.TAKEOFF
        elif self.state == ControllerState.TAKEOFF:
            dist = float(np.linalg.norm(
                pose.position - self.goto_pose.position))
            if dist <= cfg.position_tolerance:
                self.state = ControllerState.NAVIGATING
                self.is_moving = True
                self.altitude = float(pose.position[2])
        elif self.state == ControllerState.NAVIGATING:
            if self.fcu.mode != self.vehicle.offboard_mode_name:
                # Offboard off: freeze goto at current pose (flyaway guard).
                self.goto_pose = pose.copy()
            else:
                has_command = self._got_joy or self._got_dnn
                joy_active = any((self._joy.linear, self._joy.angular,
                                  self._joy.yaw, self._joy.altitude))
                if not self.use_dnn:
                    if self._got_joy:
                        linear, angular = self._joy.linear, self._joy.angular
                        yaw, alt = self._joy.yaw, self._joy.altitude
                        self._got_joy = False
                elif self._got_joy and joy_active:
                    linear, angular = self._joy.linear, self._joy.angular
                    yaw, alt = self._joy.yaw, self._joy.altitude
                    self._got_joy = False
                    self.joy_commands += 1
                elif self._got_dnn:
                    linear, angular = self._dnn_linear, self._dnn_angular
                    self._got_dnn = False
                    self.dnn_commands += 1
                else:
                    has_command = False
                    self.vehicle.execute_command(self, self.goto_pose,
                                                 0.0, 0.0, False)
                    return

                if alt != 0.0:
                    self.altitude += cfg.altitude_nudge * alt
                    self.goto_pose.position[2] = self.altitude
                if yaw != 0.0:
                    # rotate in place toward a distant virtual point
                    angular = cfg.yaw_rate_scale * yaw
                    linear = math.sqrt(max(0.0, 1 - angular * angular))
                    face = self.compute_next_waypoint(pose, linear, angular,
                                                      10.0)
                    self.goto_pose.orientation = self.rotation_to(
                        pose.position, face)
                elif linear == 0.0 and angular == 0.0:
                    if self.is_moving:
                        self.goto_pose = pose.copy()
                        self.goto_pose.position[2] = self.altitude
                        self.is_moving = False
                else:
                    self.is_moving = True
                    wp = self.compute_next_waypoint(pose, linear, angular,
                                                    cfg.linear_speed)
                    wp[2] = self.altitude
                    self.goto_pose.position = wp
                    if linear > 0:
                        self.goto_pose.orientation = self.rotation_to(
                            pose.position, wp)

        self.vehicle.execute_command(self, self.goto_pose, linear, angular,
                                     has_command)

    @property
    def ai_score(self) -> float:
        """Fraction of commands issued by the DNN (the reference's 1 Hz
        telemetry metric, `px4_controller.cpp:157-175`)."""
        total = self.dnn_commands + self.joy_commands
        return self.dnn_commands / total if total else 0.0
