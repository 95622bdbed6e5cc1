"""The port's controller, FCU bridge, MAVLink wire protocol, joystick
parser and debug pose (`redtail_tpu_torch/control`, `runtime/joystick.py`,
`runtime/debug_node.py`) against the JAX package's copies: one scripted
input sequence drives both controllers, frames are compared byte for byte,
and each package's FCU arms the other package's autopilot over the wire."""

import struct

import numpy as np
import pytest

from redtail_tpu import control as jcontrol
from redtail_tpu.control import fcu as jfcu
from redtail_tpu.control import mavlink as jmav
from redtail_tpu.runtime import debug_node as jdebug
from redtail_tpu.runtime import joystick as jjoy

from redtail_tpu_torch import control
from redtail_tpu_torch.control import fcu, geometry, mavlink
from redtail_tpu_torch.control.controller import ControllerState
from redtail_tpu_torch.runtime import debug_node, joystick

KEY = bytes(range(32))
PACKAGES = {"jax": (jcontrol, jfcu, jmav), "port": (control, fcu, mavlink)}


def _script(rs, steps=120):
    """A scripted run: poses, TrailNet probabilities, detections and
    joystick commands, one event (or none) per controller step."""
    events = []
    for i in range(steps):
        kind = rs.choice(["pose", "probs", "probs3", "dets", "joy", "none"],
                         p=[0.25, 0.35, 0.05, 0.1, 0.1, 0.15])
        if kind == "pose":
            events.append(("pose", rs.randn(3) * [5, 5, 0.5] + [0, 0, 1.5],
                           rs.uniform(-np.pi, np.pi)))
        elif kind in ("probs", "probs3"):
            p = rs.dirichlet(np.ones(3), size=2 if kind == "probs" else 1)
            events.append(("probs", p.reshape(-1).astype(np.float32)))
        elif kind == "dets":
            # a person tall enough to stop (class 14, height > 90 px) or
            # other objects and small people
            cls = rs.choice([14, 14, 2])
            events.append(("dets", np.array(
                [[cls, 0.9, 100.0, 40.0, 30.0, rs.choice([40.0, 120.0])]],
                np.float32)))
        elif kind == "joy":
            events.append(("joy", dict(
                linear=float(rs.uniform(-1, 1)) * (rs.rand() < 0.5),
                angular=float(rs.uniform(-1, 1)) * (rs.rand() < 0.5),
                dnn_on=bool(rs.rand() < 0.3),
                dnn_off=bool(rs.rand() < 0.1),
                dnn_left=bool(rs.rand() < 0.1),
                dnn_right=bool(rs.rand() < 0.1))))
        else:
            events.append(("none",))
    return events


def _drive(pkg, vehicle, events):
    ctl_mod = PACKAGES[pkg][0]
    from importlib import import_module
    geo = import_module(ctl_mod.__name__ + ".geometry")
    veh = getattr(ctl_mod, vehicle)()
    ctl = ctl_mod.Controller(veh, ctl_mod.ControllerConfig(
        direction_filter_innov_coeff=0.7))
    ctl.set_fcu_state(ctl_mod.FcuState(mode=veh.offboard_mode_name,
                                       armed=True))
    ctl.set_pose(ctl_mod.Pose())
    ctl.arm()
    ctl.step()  # -> Takeoff
    ctl.set_pose(ctl_mod.Pose(np.array([0.0, 0.0, 1.5])))
    trace = []
    for ev in events:
        if ev[0] == "pose":
            ctl.set_pose(ctl_mod.Pose(np.array(ev[1]), geo.yaw_quat(ev[2])))
        elif ev[0] == "probs":
            ctl.on_trailnet(ev[1])
        elif ev[0] == "dets":
            ctl.on_objects(ev[1])
        elif ev[0] == "joy":
            ctl.on_joystick(ctl_mod.JoyCommand(**ev[1]))
        ctl.step()
        trace.append((ctl.state.name, ctl.goto_pose.position.copy(),
                      ctl.goto_pose.orientation.copy(), ctl.ai_score,
                      ctl.use_dnn, ctl.stop_events))
    return trace


@pytest.mark.parametrize("vehicle", ["Drone", "APMRoverRC"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_controller_matches_jax_on_a_scripted_run(vehicle, seed):
    events = _script(np.random.RandomState(seed))
    want = _drive("jax", vehicle, events)
    got = _drive("port", vehicle, events)
    assert [t[0] for t in got] == [t[0] for t in want]
    # the same float64 numpy code on both sides
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[1], w[1])
        np.testing.assert_array_equal(g[2], w[2])
        assert g[3:] == w[3:]
    assert {t[0] for t in want} >= {"NAVIGATING"}


def test_controller_reaches_every_state_and_stops_for_a_person():
    ctl = control.Controller(control.Drone(), control.ControllerConfig())
    assert ctl.state == ControllerState.NOOP
    ctl.set_fcu_state(control.FcuState(mode="OFFBOARD", armed=True))
    ctl.set_pose(control.Pose())
    ctl.arm()
    ctl.step()
    assert ctl.state == ControllerState.TAKEOFF
    ctl.set_pose(control.Pose(np.array([0.0, 0.0, 1.5])))
    ctl.step()
    assert ctl.state == ControllerState.NAVIGATING
    ctl.on_joystick(control.JoyCommand(dnn_on=True))
    ctl.on_trailnet(np.array([0.1, 0.2, 0.7, 0.2, 0.6, 0.2], np.float32))
    ctl.step()
    assert ctl.use_dnn and ctl.dnn_commands == 1
    ctl.on_objects(np.array([[14, 0.95, 160, 90, 60, 120]], np.float32))
    assert ctl.stop_events == 1 and not ctl.use_dnn


@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("msg", ["HEARTBEAT", "SET_MODE", "COMMAND_LONG",
                                 "COMMAND_ACK", "LOCAL_POSITION_NED",
                                 "SET_POSITION_TARGET_LOCAL_NED"])
def test_pack_frame_byte_equal_to_jax(msg, version):
    rs = np.random.RandomState(len(msg) + version)
    values = {n: int(rs.randint(0, 200)) if t.startswith(("uint", "int"))
              else float(rs.randn()) for n, t in
              getattr(jmav, msg).wire_fields}
    seq, sysid, compid = 7, 255, 190
    got = mavlink.pack_frame(getattr(mavlink, msg), seq, sysid, compid,
                             values, version=version)
    want = jmav.pack_frame(getattr(jmav, msg), seq, sysid, compid, values,
                           version=version)
    assert got == want
    assert getattr(mavlink, msg).crc_extra == getattr(jmav, msg).crc_extra
    parsed = mavlink.Deframer().feed(want)
    assert [(m[0], m[2]) for m in parsed] == [(getattr(jmav, msg).msgid,
                                               sysid)]


def test_signed_frames_byte_equal_to_jax_with_a_fixed_clock():
    t = [1.7e9]
    frames = {}
    for name, mod in (("jax", jmav), ("port", mavlink)):
        t[0] = 1.7e9
        signer = mod.Signer(KEY, link_id=3, clock=lambda: t[0])
        out = b""
        for i in range(4):
            out += mod.pack_frame(mod.COMMAND_LONG, i, 255, 190, dict(
                target_system=1, target_component=1, command=400,
                param1=1.0), version=2, signing=signer)
            t[0] += 0.25 if i != 1 else 0.0  # a stalled clock too
        frames[name] = out
    assert frames["port"] == frames["jax"]
    # the JAX signer verifies the port's frames, replay gate included
    strict = jmav.Deframer(signing=jmav.Signer(KEY))
    assert [m[0] for m in strict.feed(frames["port"])] == \
        [jmav.COMMAND_LONG.msgid] * 4
    assert strict.feed(frames["port"]) == []  # replayed
    assert strict.signing.replays == 4


def test_x25_crc_matches_jax():
    rs = np.random.RandomState(0)
    for n in (0, 1, 9, 64, 263):
        data = rs.randint(0, 256, n).astype(np.uint8).tobytes()
        assert mavlink.x25_crc(data) == jmav.x25_crc(data)
    assert mavlink.x25_crc(b"123456789") == 0x6F91


def _arm(fcu_mod, ap_mod, fcu_pkg, **kw):
    """``fcu_mod``'s MavlinkFcu arms ``ap_mod``'s MicroAutopilot over an
    in-memory link, driven by ``fcu_pkg``'s arm_sequence."""
    link = fcu_mod.LoopbackLink()
    t = [0.0]

    def clock():
        return t[0]

    ap_kw = {"signing_key": kw["signing_key"], "link_id": 1} \
        if "signing_key" in kw else {}
    ap = ap_mod.MicroAutopilot(link.b, accept_after=2, **ap_kw)
    link_fcu = fcu_mod.MavlinkFcu(link.a, clock=clock, **kw)

    def sleep(dt):
        t[0] += dt
        ap.step()

    ctl_mod, fcu_bridge, _ = PACKAGES[fcu_pkg]
    ctl = ctl_mod.Controller(ctl_mod.Drone(), ctl_mod.ControllerConfig())
    ap.step()
    ok = fcu_bridge.arm_sequence(
        ctl, link_fcu, get_pose=lambda: ctl_mod.Pose(np.zeros(3)),
        clock=clock, sleep=sleep, retry_sec=0.2, timeout_sec=10.0)
    return ok, ctl, link_fcu, ap


@pytest.mark.parametrize("signed", [False, True], ids=["plain", "signed"])
@pytest.mark.parametrize("fcu_pkg,ap_pkg", [("port", "jax"),
                                            ("jax", "port")])
def test_fcu_arms_the_other_package_autopilot(fcu_pkg, ap_pkg, signed):
    kw = {"signing_key": KEY} if signed else {}
    ok, ctl, link_fcu, ap = _arm(PACKAGES[fcu_pkg][2], PACKAGES[ap_pkg][2],
                                 fcu_pkg, **kw)
    assert ok and ctl.state.name == "ARMED"
    assert ap.armed and ap.custom_mode == 6 << 16  # PX4 OFFBOARD
    assert ap.mode_requests >= 2 and ap.arm_requests >= 2
    assert len(ap.setpoints) >= 20
    assert link_fcu.state().armed and link_fcu._deframer.bad_crc == 0
    if signed:
        assert link_fcu.signing.bad_sig == 0 and ap.signing.bad_sig == 0


def test_setpoints_on_the_wire_match_jax():
    """ENU -> NED setpoints: the port's FCU and JAX's send the same
    values to an autopilot."""
    got = {}
    for name, (ctl_mod, _, mod) in PACKAGES.items():
        link = mod.LoopbackLink()
        link_fcu = mod.MavlinkFcu(link.a)
        ap = mod.MicroAutopilot(link.b)
        from importlib import import_module
        geo = import_module(ctl_mod.__name__ + ".geometry")
        for i in range(5):
            link_fcu.publish_setpoint(ctl_mod.Pose(
                np.array([1.0 + i, -2.0, 3.0]), geo.yaw_quat(0.3 * i)))
        ap.step()
        got[name] = ap.setpoints
    assert got["port"] == got["jax"] and len(got["port"]) == 5


def test_udp_link_carries_the_handshake():
    """The pipeline's `--fcu mavlink` wiring: two sockets bound on the
    loopback interface, the port's FCU and autopilot on either end."""
    import socket
    import threading
    import time

    s1 = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s1.bind(("127.0.0.1", 0))
    s2 = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s2.bind(("127.0.0.1", 0))
    p1, p2 = s1.getsockname()[1], s2.getsockname()[1]
    link_fcu = mavlink.MavlinkFcu(mavlink.UdpLink(("127.0.0.1", p2), sock=s1))
    ap = mavlink.MicroAutopilot(mavlink.UdpLink(("127.0.0.1", p1), sock=s2))
    stop = threading.Event()

    def loop():
        while not stop.is_set():
            ap.step()
            time.sleep(0.01)
    thread = threading.Thread(target=loop, daemon=True)
    thread.start()
    try:
        ctl = control.Controller(control.Drone(), control.ControllerConfig())
        ok = fcu.arm_sequence(ctl, link_fcu,
                              get_pose=lambda: control.Pose(np.zeros(3)),
                              retry_sec=0.2, timeout_sec=5.0)
    finally:
        stop.set()
        thread.join(5)
        s1.close()
        s2.close()
    assert not thread.is_alive()
    assert ok and ap.armed and link_fcu._deframer.bad_crc == 0


def test_simulated_fcu_arm_sequence():
    ctl = control.Controller(control.Drone(), control.ControllerConfig())
    sim = fcu.SimulatedFcu(accept_after=3)
    t = [0.0]
    ok = fcu.arm_sequence(ctl, sim, get_pose=lambda: control.Pose(),
                          clock=lambda: t[0],
                          sleep=lambda dt: t.__setitem__(0, t[0] + dt),
                          retry_sec=0.1, timeout_sec=5.0)
    assert ok and sim.state().armed and ctl.state == ControllerState.ARMED


def test_joystick_parser_matches_jax():
    rs = np.random.RandomState(3)
    codes = [(0x03, c) for c in (0x00, 0x01, 0x03, 0x04)] + \
        [(0x01, c) for c in (0x130, 0x131)]
    stream = b""
    for _ in range(40):
        typ, code = codes[rs.randint(len(codes))]
        value = int(rs.randint(-32768, 32767)) if typ == 0x03 \
            else int(rs.randint(0, 2))
        stream += struct.pack("qqHHi", 0, 0, typ, code, value)
    seen = {}
    for name, mod in (("jax", jjoy), ("port", joystick)):
        parser = mod.JoystickState({0x00: mod.AbsInfo(-32768, 32767)})
        cmds = []
        for i in range(0, len(stream), 17):  # arbitrary chunking
            parser.feed(stream[i:i + 17])
            cmds.append(vars(parser.command))
        seen[name] = cmds
    assert seen["port"] == seen["jax"]
    assert any(c["dnn_on"] for c in seen["port"])


def test_debug_pose_matches_jax():
    for probs in ([0.7, 0.2, 0.1, 0.1, 0.3, 0.6], [0.2, 0.6, 0.2],
                  [0.0, 0.0, 1.0, 1.0, 0.0, 0.0]):
        got = debug_node.probs_to_debug_pose(probs)
        want = jdebug.probs_to_debug_pose(probs)
        assert (got.yaw, got.y_offset) == (want.yaw, want.y_offset)
        np.testing.assert_array_equal(got.as_quaternion(),
                                      want.as_quaternion())


def test_geometry_matches_jax():
    from redtail_tpu.control import geometry as jgeo
    rs = np.random.RandomState(4)
    for _ in range(10):
        yaw = rs.uniform(-np.pi, np.pi)
        np.testing.assert_array_equal(geometry.yaw_quat(yaw),
                                      jgeo.yaw_quat(yaw))
        q = jgeo.yaw_quat(yaw)
        assert geometry.quat_yaw(q) == jgeo.quat_yaw(q)
