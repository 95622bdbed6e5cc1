"""Full perception + control pipeline (`redtail_tpu/apps/pipeline_app.py`),
the `everything.launch` equivalent
(`ros/packages/caffe_ros/launch/everything.launch`): camera source ->
TrailNet (30 Hz) + YOLO (1 Hz) + stereo -> controller, all as in-process
nodes over the latest-wins topic graph, the DNN nodes on the card
(``--cpu`` for the CPU).

Runs against video files (with `cv2`) or synthetic frames; prints the
profiler table and, as its last line, one JSON summary: frames published
per node, the controller's AI score and stop events, every node's error
count, and with ``--fcu mavlink`` the MAVLink link's state.

    python -m redtail_tpu_torch.apps.pipeline_app --duration 8 \\
        --trailnet-prototxt trailnet.prototxt --fcu mavlink
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def build_argparser():
    p = argparse.ArgumentParser(description="redtail pipeline (PyTorch)")
    p.add_argument("--video", help="video file for the camera topic "
                   "(default: synthetic frames)")
    p.add_argument("--video-sbs", help="side-by-side stereo video: each "
                   "frame is split into the L/R camera topics with one "
                   "shared timestamp (the ZED-pair role, "
                   "stereo_dnn_ros/launch/zed.launch)")
    p.add_argument("--video-left", help="left-camera video file "
                   "(pair with --video-right; frames iterated in "
                   "lockstep)")
    p.add_argument("--video-right", help="right-camera video file")
    p.add_argument("--viz-out", metavar="DIR",
                   help="write 2x2 disparity mosaics (L|R ; gray|KITTI "
                   "color) to DIR from a 3-way-synced viz node — the "
                   "stereo_dnn_ros_viz role")
    p.add_argument("--viz-every", type=int, default=10,
                   help="write every Nth mosaic (default 10)")
    p.add_argument("--stereo-model", default="resnet18_2d",
                   choices=["nvtiny", "nvsmall", "resnet18", "resnet18_2d"])
    p.add_argument("--stereo-checkpoint",
                   help="TF checkpoint prefix of the stereo model (random "
                   "weights without it)")
    p.add_argument("--trailnet-prototxt")
    p.add_argument("--trailnet-caffemodel")
    p.add_argument("--trailnet-rate", type=float, default=30.0)
    p.add_argument("--yolo-prototxt", help="YOLO graph (default: the "
                   "reference's yolo-relu.prototxt if present)")
    p.add_argument("--yolo-caffemodel")
    p.add_argument("--yolo-rate", type=float, default=1.0,
                   help="object-detection rate in Hz; 0 disables YOLO "
                   "(everything.launch ran it at 1 Hz)")
    p.add_argument("--demo-person-stop", type=float, metavar="T", default=None,
                   help="inject one synthetic person-sized detection into "
                   "object_dnn/network/output after T seconds, exercising "
                   "the controller's person-stop interlock live")
    p.add_argument("--joystick", metavar="DEVICE",
                   help="evdev joystick device (e.g. /dev/input/event3): "
                        "teleop override + DNN on/off buttons "
                        "(`joystickCallback:178-236`); skipped with a "
                        "warning when absent")
    p.add_argument("--overlap", type=int, default=1,
                   help="frames in flight per DNN node (default 1): "
                   "dispatch frame N, publish frame N-1 under its true "
                   "stamp, so the card computes while the host prepares "
                   "the next frame. 0 = synchronous")
    p.add_argument("--microbatch", type=int, default=1,
                   help="frames per DNN dispatch (default 1): amortizes "
                   "the device round-trip over M frames at up to M-1 "
                   "frame periods of extra latency; results still publish "
                   "under their true per-frame stamps. Requires "
                   "--overlap >= 1")
    p.add_argument("--yolo-overlap", type=int, default=0,
                   help="frames in flight for the YOLO node (default 0 "
                   "= synchronous): detections feed the person-stop "
                   "safety interlock, where a frame of staleness is a "
                   "full yolo period (~1 s at --yolo-rate 1) of delayed "
                   "reaction")
    p.add_argument("--wire", default="f32", choices=["f32", "u16"],
                   help="disparity device->host transport: 'u16' ships "
                   "fixed-point round(disp*64) as 16 bits, half the copy's "
                   "bytes at 1/64 px steps (saturating at 1023.98 px)")
    p.add_argument("--control-rate", type=float, default=20.0)
    p.add_argument("--duration", type=float, default=10.0)
    p.add_argument("--vehicle", default="drone",
                   choices=["drone", "apmrover_rc"])
    p.add_argument("--fcu", default="sim",
                   help="'sim' (no wire protocol, instant arm), "
                   "'mavlink' (full MAVLink handshake + setpoint stream "
                   "against an in-process wire-level autopilot over real "
                   "UDP sockets on the loopback interface), or "
                   "'mavlink:HOST:PORT' for an external FCU (PX4 SITL / "
                   "hardware, e.g. 127.0.0.1:14540)")
    p.add_argument("--mavlink-sign-key", metavar="HEX64",
                   help="64-hex-char MAVLink v2 signing key (PX4 "
                   "SETUP_SIGNING semantics): sign outbound frames, "
                   "verify + replay-gate inbound, drop unsigned")
    p.add_argument("--cpu", action="store_true",
                   help="run the DNN nodes on the CPU instead of the card")
    return p


def _setup_fcu(args, ctl, vehicle):
    """Returns (fcu_or_None, background_stop_fn)."""
    import numpy as np

    from redtail_tpu_torch.control import Pose
    from redtail_tpu_torch.control.fcu import arm_sequence

    if args.fcu == "sim":
        return None, lambda: None
    import socket
    import threading

    from redtail_tpu_torch.control.mavlink import (MavlinkFcu,
                                                   MicroAutopilot, UdpLink)
    px4 = vehicle.offboard_mode_name == "OFFBOARD"
    sign_key = (bytes.fromhex(args.mavlink_sign_key)
                if args.mavlink_sign_key else None)
    stop = threading.Event()
    thread = None
    if args.fcu == "mavlink":
        # bind both sockets once and hand them over (no close/rebind
        # window for another process to take the ports)
        s1 = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s1.bind(("127.0.0.1", 0))
        s2 = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s2.bind(("127.0.0.1", 0))
        p1, p2 = s1.getsockname()[1], s2.getsockname()[1]
        fcu = MavlinkFcu(UdpLink(("127.0.0.1", p2), sock=s1), px4=px4,
                         signing_key=sign_key)
        ap = MicroAutopilot(UdpLink(("127.0.0.1", p1), sock=s2), px4=px4,
                            signing_key=sign_key)

        def ap_loop():
            while not stop.is_set():
                ap.step()
                time.sleep(0.02)
        thread = threading.Thread(target=ap_loop, daemon=True)
        thread.start()
    else:
        host, port = args.fcu.split(":")[1:]
        fcu = MavlinkFcu(UdpLink((host, int(port))), px4=px4,
                         signing_key=sign_key)
    ok = arm_sequence(ctl, fcu, get_pose=lambda: Pose(np.zeros(3)),
                      retry_sec=0.5, timeout_sec=30.0)
    if not ok:
        stop.set()
        raise SystemExit("FCU arming handshake failed")
    print("FCU armed over MAVLink", file=sys.stderr)

    def stop_fn():
        stop.set()
        if thread is not None:
            thread.join()
    return fcu, stop_fn


def main(argv=None):
    args = build_argparser().parse_args(argv)
    if bool(args.video_left) != bool(args.video_right):
        raise SystemExit("--video-left and --video-right must be given "
                         "together (or use --video-sbs)")

    import numpy as np

    from redtail_tpu_torch import resolve_device
    from redtail_tpu_torch.control import (
        APMRoverRC, Controller, ControllerConfig, Drone, FcuState,
        JoyCommand, Pose)
    from redtail_tpu_torch.models import (STEREO_SPECS, init_stereo_params,
                                          load_stereo_params)
    from redtail_tpu_torch.models.trailnet import load_trailnet
    from redtail_tpu_torch.runtime import NodeGraph, StageProfiler
    from redtail_tpu_torch.runtime.nodes import (StereoNode, TrailNetNode,
                                                 YoloNode)
    from redtail_tpu_torch.runtime.sources import (SyntheticSource,
                                                   VideoFileSource)

    # XLA's persistent compilation cache (the JAX app's engine-cache
    # parity) has no counterpart: the CUDA kernels are cached by the hash
    # of their source at first use (kernels/_build.py).
    device = resolve_device("cpu" if args.cpu else None)
    prof = StageProfiler()
    g = NodeGraph()

    # --- DNN stages
    spec = STEREO_SPECS[args.stereo_model]
    sparams = (load_stereo_params(args.stereo_checkpoint)
               if args.stereo_checkpoint else init_stereo_params(spec))
    stereo = StereoNode(spec, sparams, profiler=prof,
                        device=device, overlap=args.overlap,
                        microbatch=args.microbatch, wire=args.wire)
    trailnet = TrailNetNode(
        load_trailnet(args.trailnet_prototxt,
                      caffemodel_path=args.trailnet_caffemodel,
                      device=device)
        if args.trailnet_prototxt else None, profiler=prof, device=device,
        overlap=args.overlap, microbatch=args.microbatch) \
        if args.trailnet_prototxt or _default_prototxt_exists() else None
    yolo = None
    if args.yolo_rate > 0:
        yolo_proto = args.yolo_prototxt or _default_yolo_prototxt()
        if yolo_proto:
            from redtail_tpu_torch.io.caffe import (load_caffemodel,
                                                    load_prototxt)
            from redtail_tpu_torch.models.caffe_net import CaffeNet
            proto = load_prototxt(yolo_proto)
            yolo = YoloNode(
                CaffeNet(proto, load_caffemodel(args.yolo_caffemodel),
                         device=device)
                if args.yolo_caffemodel else
                CaffeNet(proto, seed=3, device=device),
                profiler=prof, device=device, overlap=args.yolo_overlap)

    # --- controller
    vehicle = Drone() if args.vehicle == "drone" else APMRoverRC()
    ctl = Controller(vehicle, ControllerConfig(
        spin_rate_hz=args.control_rate))
    fcu, fcu_stop = _setup_fcu(args, ctl, vehicle)
    if fcu is None:
        ctl.set_fcu_state(FcuState(mode=vehicle.offboard_mode_name,
                                   armed=True))
        ctl.set_pose(Pose())
        ctl.arm()
    ctl.step()  # Armed -> Takeoff
    ctl.set_pose(Pose(np.array([0.0, 0.0, 1.5])))
    ctl.step()  # -> Navigating
    joystick = None
    if args.joystick:
        from redtail_tpu_torch.runtime.joystick import EvdevJoystick
        joystick = EvdevJoystick(args.joystick, ctl.on_joystick)
        if not joystick.start():
            print(f"warning: joystick {args.joystick} unavailable, "
                  "enabling DNN control directly", flush=True)
            joystick = None
    if joystick is None:
        # no joystick in this composition: enable DNN control directly
        # (the reference's operator pressed the A button,
        # `joystickCallback:216`)
        ctl.on_joystick(JoyCommand(dnn_on=True))

    # --- graph wiring (everything.launch topology)
    # microbatched stages publish M results back to back; retain the
    # burst so every frame stays observable to take_since() consumers
    # (latest-wins subscribers like the controller are unaffected)
    g.topic("stereo/disparity", history=args.microbatch)
    g.add_node("stereo", stereo, ["camera/left", "camera/right"],
               "stereo/disparity", max_rate_hz=30.0, sync_slop=0.1)
    if trailnet is not None:
        from redtail_tpu_torch.runtime.nodes import tap_stage
        g.topic("trails_dnn/network/output", history=args.microbatch)
        g.add_node("trailnet", tap_stage(trailnet, ctl.on_trailnet),
                   ["camera/left"], "trails_dnn/network/output",
                   max_rate_hz=args.trailnet_rate)

    if yolo is not None:
        g.add_node("yolo", yolo, ["camera/left"],
                   "object_dnn/network/output", max_rate_hz=args.yolo_rate)
    if yolo is not None or args.demo_person_stop is not None:
        # Detections route to the controller via the topic, mirroring
        # px4_controller's objDnnCallback subscription
        # (`px4_controller.cpp:280-349`, `everything.launch:40-62`),
        # wired whenever anything can publish detections (the
        # --demo-person-stop injection with YOLO absent included).
        def objstop_stage(dets):
            ctl.on_objects(dets)
            return None
        g.add_node("objstop", objstop_stage, ["object_dnn/network/output"],
                   None, max_rate_hz=args.control_rate)

    def control_stage(_disp):
        with prof.stage("controller"):
            ctl.step()
            if fcu is not None:
                # stream setpoints on the wire, as px4_controller's
                # spin loop published each iteration (`:700-712`)
                fcu.publish_setpoint(ctl.goto_pose)
        return None
    g.add_node("controller", control_stage, ["stereo/disparity"], None,
               max_rate_hz=args.control_rate)

    # --- viz sink (the stereo_dnn_ros_viz node, 3-way synced)
    viz = None
    if args.viz_out:
        from redtail_tpu_torch.runtime.nodes import VizNode
        viz = VizNode(args.viz_out, max_disp=spec.full_max_disp,
                      every=args.viz_every, profiler=prof)
        g.add_node("viz", viz,
                   ["camera/left", "camera/right", "stereo/disparity"],
                   None, max_rate_hz=30.0, sync_slop=0.5)

    # --- sources
    shape = (spec.input_hw[0], spec.input_hw[1], 3)
    src_r = None
    if args.video_sbs or (args.video_left and args.video_right):
        from redtail_tpu_torch.runtime.sources import StereoVideoSource
        src_l = StereoVideoSource(
            g.topic("camera/left"), g.topic("camera/right"),
            sbs_path=args.video_sbs, left_path=args.video_left,
            right_path=args.video_right, rate_hz=30.0, repeat=True)
    elif args.video:
        src_l = VideoFileSource(g.topic("camera/left"), args.video,
                                rate_hz=30.0, repeat=True)
        src_r = SyntheticSource(g.topic("camera/right"), shape,
                                rate_hz=30.0, seed=1)
    else:
        src_l = SyntheticSource(g.topic("camera/left"), shape, rate_hz=30.0)
        src_r = SyntheticSource(g.topic("camera/right"), shape,
                                rate_hz=30.0, seed=1)

    # --- warm-up: build the kernels and exercise every path before
    # spinning (the reference likewise built its TRT engines before the
    # node loops, `tensor_net.cpp:194-213`); --duration then measures
    # steady state.
    dummy = np.zeros(shape, np.uint8)
    t0 = time.monotonic()
    stereo.warmup(dummy, dummy)
    if trailnet is not None:
        trailnet.warmup(dummy)
    if yolo is not None:
        yolo.warmup(dummy)
    print(f"engines ready in {time.monotonic() - t0:.1f}s", file=sys.stderr)
    prof.reset()  # drop the warm-up samples

    g.start()
    src_l.start()
    if src_r is not None:
        src_r.start()
    injected_dets = 0
    try:
        deadline = time.monotonic() + args.duration
        while time.monotonic() < deadline:
            if (args.demo_person_stop is not None and not injected_dets
                    and time.monotonic() >= deadline - args.duration
                    + args.demo_person_stop):
                # One person-sized detection (class 14, prob 0.95, box
                # height > 0.5 * 180 px: the interlock thresholds of
                # `px4_controller.h:115-118`) through the topic the real
                # YOLO detections ride.
                det = np.array([[14.0, 0.95, 160.0, 90.0, 60.0, 120.0]],
                               np.float32)
                g.topic("object_dnn/network/output").publish(det)
                injected_dets = 1
            time.sleep(0.05)
    finally:
        src_l.stop()
        if src_r is not None:
            src_r.stop()
        if joystick is not None:
            joystick.stop()
        g.stop()
        fcu_stop()

    print(prof.report(), file=sys.stderr)
    # Publishes (topic seq), not node ticks: an overlapped stage's tick
    # can return None (batch filling, result in flight), so `processed`
    # would overcount output frames. The --demo-person-stop injection
    # rides the yolo output topic; it is subtracted from yolo's count.
    stats = {name: (node.output.count if node.output is not None
                    else node.processed)
             for name, node in g.nodes.items()}
    if "yolo" in stats:
        stats["yolo"] -= injected_dets
    summary = {"frames": stats, "ai_score": ctl.ai_score,
               "stop_events": ctl.stop_events,
               "dnn_active": ctl.use_dnn,
               "errors": {n: v.errors for n, v in g.nodes.items()}}
    if fcu is not None:
        summary["mavlink"] = {"state": ctl.state.name,
                              "armed": fcu.state().armed,
                              "bad_crc": fcu._deframer.bad_crc}
    if viz is not None:
        summary["viz"] = {"mosaics": viz.frames, "written": viz.written,
                          "dir": args.viz_out}
    if hasattr(src_l, "published"):
        summary["stereo_source"] = {
            "pairs" if src_r is None else "frames": src_l.published}
    print(json.dumps(summary))


def _default_prototxt_exists():
    from redtail_tpu_torch.models.trailnet import DEFAULT_PROTOTXT
    return DEFAULT_PROTOTXT.exists()


def _default_yolo_prototxt():
    """The reference's YOLO graph beside its TrailNet one, where present
    (as in the JAX app; not in this repository)."""
    from redtail_tpu_torch.models.trailnet import DEFAULT_PROTOTXT
    p = DEFAULT_PROTOTXT.parent / "yolo-relu.prototxt"
    return p if p.exists() else None


if __name__ == "__main__":
    main()
