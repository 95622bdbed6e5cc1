"""FCU (flight-controller) bridge: arming handshake + mode switching.

Behavioral port of `PX4Controller::arm()`
(`ros/packages/px4_controller/src/px4_controller.cpp:583-692`):

1. warm-up: stream current-pose setpoints while smoothing the pose
   estimate exponentially (`:606-629`),
2. request the vehicle's offboard mode (OFFBOARD / MANUAL / GUIDED) and
   arming through the FCU services, retrying every ``retry_sec`` (5 s)
   until ``timeout_sec`` (30 s) (`:631-689`).

``FcuInterface`` is the seam: `SimulatedFcu` for tests and simulation,
`control.mavlink.MavlinkFcu` speaks the real MAVLink wire protocol
(heartbeat/set_mode/arm/setpoint over serial or UDP) for hardware — the
slice of MAVROS the reference actually used.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np

from redtail_tpu_torch.control.controller import FcuState, Pose


class FcuInterface:
    """What the arming sequence needs from a flight-controller link."""

    def state(self) -> FcuState:
        raise NotImplementedError

    def set_mode(self, mode: str) -> bool:
        raise NotImplementedError

    def arm(self) -> bool:
        raise NotImplementedError

    def publish_setpoint(self, pose: Pose) -> None:
        raise NotImplementedError


class SimulatedFcu(FcuInterface):
    """Accepts mode/arming after a configurable number of attempts
    (exercises the retry loop) and records published setpoints."""

    def __init__(self, accept_after: int = 1):
        self.accept_after = accept_after
        self.mode_requests = 0
        self.arm_requests = 0
        self._state = FcuState(mode="", armed=False)
        self.setpoints = []

    def state(self) -> FcuState:
        return self._state

    def set_mode(self, mode: str) -> bool:
        self.mode_requests += 1
        if self.mode_requests >= self.accept_after:
            self._state = FcuState(mode=mode, armed=self._state.armed)
            return True
        return False

    def arm(self) -> bool:
        self.arm_requests += 1
        if self.arm_requests >= self.accept_after:
            self._state = FcuState(mode=self._state.mode, armed=True)
            return True
        return False

    def publish_setpoint(self, pose: Pose) -> None:
        self.setpoints.append(pose.copy())


def arm_sequence(controller, fcu: FcuInterface, *,
                 get_pose: Callable[[], Pose],
                 warmup_iters: int = 20, smoothing: float = 0.9,
                 retry_sec: float = 5.0, timeout_sec: float = 30.0,
                 sleep: Callable[[float], None] = time.sleep,
                 clock: Callable[[], float] = time.monotonic) -> bool:
    """Run the warm-up + mode/arm handshake; on success the controller
    enters the Armed state. Returns False on timeout (the reference
    aborts with an error, `:688-689`)."""
    # Warm-up: smooth the pose and stream it as the initial setpoint —
    # PX4 requires setpoints flowing before OFFBOARD engages.
    pose = get_pose().copy()
    for _ in range(warmup_iters):
        cur = get_pose()
        pose.position = smoothing * pose.position \
            + (1.0 - smoothing) * cur.position
        pose.orientation = cur.orientation
        fcu.publish_setpoint(pose)
    controller.set_pose(pose)

    mode = controller.vehicle.offboard_mode_name
    deadline = clock() + timeout_sec
    next_try = clock()
    mode_ok = False
    armed = False
    while clock() < deadline:
        st = fcu.state()
        mode_ok = st.mode == mode
        armed = st.armed
        if mode_ok and armed:
            controller.set_fcu_state(st)
            controller.arm()
            return True
        if clock() >= next_try:
            if not mode_ok:
                fcu.set_mode(mode)
            elif not armed:
                fcu.arm()
            next_try = clock() + retry_sec
        fcu.publish_setpoint(pose)
        sleep(0.01)
    return False
