"""Joystick input: raw Linux evdev reader -> `JoyCommand` stream.

The reference consumed a ROS `/joy` topic and mapped sticks/buttons to
teleop overrides and DNN on/off switches
(`px4_controller.cpp:178-236`, `joystickCallback`); joy_node did the
hardware read. This framework reads the kernel evdev device directly —
no external package: `struct input_event` is fixed-layout (timeval +
type/code/value) and the axis ranges come from the `EVIOCGABS` ioctl.

Default mapping (xbox-style, the reference's `joy_type:=xbox_wired`
layout): left stick Y -> linear (push forward = +), left stick X ->
angular (left = +), right stick X -> yaw, right stick Y -> altitude;
A (BTN_SOUTH) -> dnn_on, B (BTN_EAST) -> dnn_off — the operator's
"engage/disengage autonomy" buttons (`joystickCallback:216-227`).

The byte-stream parser is separated from the device I/O so tests can
drive it with synthetic packed events (no hardware in CI).
"""

from __future__ import annotations

import struct
import threading
from dataclasses import dataclass
from typing import Callable, Dict, Optional

from redtail_tpu_torch.control import JoyCommand

# struct input_event on LP64: struct timeval (2 x u64) + u16 type +
# u16 code + s32 value = 24 bytes.
_EVENT_FMT = "qqHHi"
EVENT_SIZE = struct.calcsize(_EVENT_FMT)

EV_KEY = 0x01
EV_ABS = 0x03

ABS_X, ABS_Y, ABS_RX, ABS_RY = 0x00, 0x01, 0x03, 0x04
BTN_SOUTH, BTN_EAST = 0x130, 0x131  # A, B


@dataclass
class AbsInfo:
    minimum: int = -32768
    maximum: int = 32767

    def normalize(self, value: int) -> float:
        span = self.maximum - self.minimum
        if span <= 0:
            return 0.0
        x = 2.0 * (value - self.minimum) / span - 1.0
        return max(-1.0, min(1.0, x))


class JoystickState:
    """Pure event-stream -> JoyCommand accumulator (no I/O).

    Feed it packed `input_event` bytes (any chunking); read `.command`.
    """

    #: axis code -> (field, sign). Y axes are inverted: evdev reports
    #: stick-up as negative, the controller wants push-forward positive.
    AXIS_MAP: Dict[int, tuple] = {
        ABS_Y: ("linear", -1.0),
        ABS_X: ("angular", -1.0),   # left = positive turn (REP-103 z-up)
        ABS_RX: ("yaw", -1.0),
        ABS_RY: ("altitude", -1.0),
    }
    BUTTON_MAP: Dict[int, str] = {
        BTN_SOUTH: "dnn_on",
        BTN_EAST: "dnn_off",
    }

    def __init__(self, absinfo: Optional[Dict[int, AbsInfo]] = None):
        self._absinfo = absinfo or {}
        self._values: Dict[str, float] = {}
        self._buttons: Dict[str, bool] = {}
        self._buf = b""
        self._lock = threading.Lock()

    def feed(self, data: bytes) -> int:
        """Consume packed events; returns how many were applied."""
        n = 0
        with self._lock:
            self._buf += data
            while len(self._buf) >= EVENT_SIZE:
                chunk, self._buf = (self._buf[:EVENT_SIZE],
                                    self._buf[EVENT_SIZE:])
                _, _, etype, code, value = struct.unpack(_EVENT_FMT, chunk)
                self._apply(etype, code, value)
                n += 1
        return n

    def _apply(self, etype: int, code: int, value: int) -> None:
        if etype == EV_ABS and code in self.AXIS_MAP:
            field, sign = self.AXIS_MAP[code]
            info = self._absinfo.get(code, AbsInfo())
            self._values[field] = sign * info.normalize(value)
        elif etype == EV_KEY and code in self.BUTTON_MAP:
            # Buttons are momentary triggers (the reference latched the
            # DNN state on press, `joystickCallback:216-227`): expose the
            # press edge; the consumer clears it after delivery.
            if value:
                self._buttons[self.BUTTON_MAP[code]] = True

    @property
    def command(self) -> JoyCommand:
        """Current JoyCommand; button edges are consumed by this read."""
        with self._lock:
            cmd = JoyCommand(
                linear=self._values.get("linear", 0.0),
                angular=self._values.get("angular", 0.0),
                yaw=self._values.get("yaw", 0.0),
                altitude=self._values.get("altitude", 0.0),
                dnn_on=self._buttons.pop("dnn_on", False),
                dnn_off=self._buttons.pop("dnn_off", False),
            )
        return cmd


def read_absinfo(fd: int, axis: int) -> AbsInfo:
    """EVIOCGABS(axis): query one axis' range from the device."""
    import fcntl

    # _IOR('E', 0x40 + axis, struct input_absinfo[6 x s32])
    req = (2 << 30) | (24 << 16) | (ord("E") << 8) | (0x40 + axis)
    buf = bytearray(24)
    fcntl.ioctl(fd, req, buf)
    _value, minimum, maximum, _fuzz, _flat, _res = struct.unpack(
        "iiiiii", bytes(buf))
    return AbsInfo(minimum, maximum)


class EvdevJoystick:
    """Background reader of a /dev/input/event* device.

    ``on_command`` is called with a JoyCommand after every drained batch
    of events (the reference's /joy callback role). `start()` is a no-op
    failure (returns False) when the device is absent/unreadable —
    joystick hardware is optional on every platform the stack runs on.
    """

    def __init__(self, device_path: str,
                 on_command: Callable[[JoyCommand], None]):
        self.device_path = device_path
        self.on_command = on_command
        self._file = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.state: Optional[JoystickState] = None

    def start(self) -> bool:
        try:
            self._file = open(self.device_path, "rb", buffering=0)
            absinfo = {}
            for axis in JoystickState.AXIS_MAP:
                try:
                    absinfo[axis] = read_absinfo(self._file.fileno(), axis)
                except OSError:
                    pass  # axis not present; default range
        except OSError:
            return False
        self.state = JoystickState(absinfo)
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="joystick")
        self._thread.start()
        return True

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                data = self._file.read(EVENT_SIZE * 16)
            except (OSError, ValueError):
                break
            if not data:
                break
            if self.state.feed(data):
                self.on_command(self.state.command)

    def stop(self) -> None:
        self._stop.set()
        if self._file is not None:
            try:
                self._file.close()
            except OSError:
                pass
        if self._thread is not None:
            self._thread.join(timeout=2.0)
