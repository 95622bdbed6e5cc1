"""Navigation controller: behavioral port of the reference
`px4_controller` (`ros/packages/px4_controller/src/px4_controller.cpp`) —
the state machine, DNN->turn-angle control law, waypoint math, joystick
arbitration, and person-stop interlock — decoupled from ROS/MAVROS behind a
thin FCU interface.  `control.mavlink` provides the real wire protocol
(MAVLink v1 over serial/UDP); `control.fcu.SimulatedFcu` the test double."""

from redtail_tpu_torch.control.controller import (
    Controller,
    ControllerConfig,
    ControllerState,
    FcuState,
    JoyCommand,
    Pose,
)
from redtail_tpu_torch.control.vehicles import APMRoverRC, Drone, Vehicle

__all__ = [
    "Controller",
    "ControllerConfig",
    "ControllerState",
    "FcuState",
    "JoyCommand",
    "Pose",
    "Vehicle",
    "Drone",
    "APMRoverRC",
]
