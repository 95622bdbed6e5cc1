"""Closed-loop trail-following simulation (`redtail_tpu/apps/sim_app.py`),
the role the reference's Gazebo/PX4-SITL docker rig played
(`tools/simulation/`): validate the full control loop without hardware.

World model: a parametric trail curve in the XY plane. Each tick, a
TrailNet classifies the vehicle's view relative to the trail, the
controller turns the 6 probabilities into a waypoint, and the vehicle
tracks it. Success = bounded cross-track error along a curving trail.

Two perception modes:

- **virtual** (default): an analytic classifier derives the 6
  probabilities from the true pose (orientation error -> view class,
  cross-track error -> side class, with label noise) — fast controller
  validation.
- **--real-dnn**: the ACTUAL TrailNet SResNet-18 graph runs in the loop
  (the role Gazebo-rendered frames played in the reference's SITL rig):
  each tick a ground-plane raycast renders the vehicle's 320x180 camera
  view of the trail (`render_trail_view`), and `trailnet_forward` with
  the committed synthetic-trained weights
  (`tests/data/trailnet_synth_trained.npz`, produced by
  `tools/train_trailnet_synth.py`) classifies it. The probabilities the
  controller consumes come out of the real network, closing the
  perception loop end to end.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from redtail_tpu_torch.control import (
    Controller,
    ControllerConfig,
    ControllerState,
    Drone,
    FcuState,
    JoyCommand,
    Pose,
)
from redtail_tpu_torch.control.geometry import quat_yaw, yaw_quat


@dataclass
class Trail:
    """y = amplitude * sin(2*pi*x / period): a gently curving trail."""

    amplitude: float = 8.0
    period: float = 120.0

    def y(self, x: float) -> float:
        return self.amplitude * math.sin(2 * math.pi * x / self.period)

    def heading(self, x: float) -> float:
        dy = self.amplitude * 2 * math.pi / self.period * math.cos(
            2 * math.pi * x / self.period)
        return math.atan2(dy, 1.0)

    def cross_track(self, x: float, y: float) -> float:
        return y - self.y(x)


def virtual_trailnet(pose: Pose, trail: Trail, rng: np.random.RandomState,
                     *, view_thresh_rad: float = 0.05,
                     side_thresh_m: float = 1.0,
                     noise: float = 0.1) -> np.ndarray:
    """Ground-truth-derived 6 probabilities with label noise.

    Class conventions follow the controller's law
    (`computeDNNControl`): p[0]=left view (trail bends left of heading
    -> must turn RIGHT? no: turn = angle*(p_right - p_left), positive
    turn = left). If the vehicle points LEFT of the trail direction, the
    trail appears to the right -> p[2] ("right view") fires and the
    controller turns... the signs below were tuned so the closed loop
    converges, mirroring how the real network was trained."""
    x, y = float(pose.position[0]), float(pose.position[1])
    yaw_err = quat_yaw(pose.orientation) - trail.heading(x)
    yaw_err = (yaw_err + math.pi) % (2 * math.pi) - math.pi
    ct = trail.cross_track(x, y)

    view = np.full(3, noise / 2)
    if yaw_err > view_thresh_rad:      # pointing left of trail -> view right
        view[0] = 1.0                  # "left view" -> turn right
    elif yaw_err < -view_thresh_rad:
        view[2] = 1.0
    else:
        view[1] = 1.0
    if ct > side_thresh_m:             # drifted left of the trail
        side = np.array([1.0, noise / 2, noise / 2])
    elif ct < -side_thresh_m:
        side = np.array([noise / 2, noise / 2, 1.0])
    else:
        side = np.array([noise / 2, 1.0, noise / 2])
    view = view / view.sum()
    side = side / side.sum()
    return np.concatenate([view, side])


# ----------------------------------------------------- camera rendering


def render_trail_view(trail: Trail, x: float, y: float, yaw: float, *,
                      hw=(180, 320), fov_deg: float = 100.0,
                      cam_height: float = 1.5, trail_width: float = 2.2,
                      noise: float = 8.0, max_range: float = 60.0,
                      rng: Optional[np.random.RandomState] = None
                      ) -> np.ndarray:
    """Ground-plane raycast of the trail world: (H, W, 3) float32 RGB in
    [0, 255] — the vehicle's forward camera view at pose (x, y, yaw).

    Per pixel (u, v) the ray `forward + right*u - up*v` hits the ground
    plane at s = cam_height / v; the hit point is dirt if its vertical
    distance to the trail curve is inside the trail half-width, grass
    otherwise; above the horizon is sky, and a distance haze fades the
    far field (crude textured polygons are all TrailNet needs — it
    classifies trail-relative geometry, not photorealism)."""
    h, w = hw
    f = (w / 2) / math.tan(math.radians(fov_deg) / 2)
    u = (np.arange(w) - (w - 1) / 2) / f            # lateral tangent
    v = (np.arange(h) - (h - 1) / 2) / f            # vertical, + = down
    sky = np.array([140.0, 170.0, 215.0], np.float32)
    grass = np.array([70.0, 115.0, 55.0], np.float32)
    dirt = np.array([150.0, 125.0, 95.0], np.float32)
    below = v > 1e-4
    s = np.where(below, cam_height / np.clip(v, 1e-6, None), np.inf)
    fwd = np.array([math.cos(yaw), math.sin(yaw)])
    right = np.array([math.sin(yaw), -math.cos(yaw)])
    gx = x + s[:, None] * (fwd[0] + right[0] * u[None, :])
    gy = y + s[:, None] * (fwd[1] + right[1] * u[None, :])
    with np.errstate(invalid="ignore"):
        ct = gy - trail.amplitude * np.sin(2 * np.pi * gx / trail.period)
        on_trail = np.abs(ct) < trail_width / 2
        # world-keyed texture so ego-motion is visible frame to frame
        tex = 10.0 * np.sin(gx * 7.3) * np.cos(gy * 5.1)
    ground = np.where(on_trail[..., None], dirt, grass) + \
        np.nan_to_num(tex, posinf=0.0, neginf=0.0)[..., None]
    fade = np.clip(np.nan_to_num(s, posinf=1e9)[:, None] / max_range,
                   0.0, 1.0)[..., None]
    ground = ground * (1 - fade) + sky * fade
    img = np.where(below[:, None, None], ground, sky[None, None, :])
    if rng is not None and noise > 0:
        img = img + rng.randn(h, w, 3) * noise
    return np.clip(img, 0.0, 255.0).astype(np.float32)


def sample_labeled_view(trail: Trail, rng: np.random.RandomState, *,
                        hw=(180, 320)):
    """Render one training sample: (image, view_class, side_class).

    Pose sampled per class with margins around the virtual classifier's
    thresholds (0.05 rad / 1.0 m), so labels are unambiguous. Class
    conventions match `virtual_trailnet`: pointing LEFT of the trail
    heading -> view 0; drifted LEFT of the trail -> side 0 (the
    controller law then steers right, `computeDNNControl`)."""
    view_cls = int(rng.randint(3))
    side_cls = int(rng.randint(3))
    x = float(rng.uniform(0, trail.period))
    yaw_err = {0: rng.uniform(0.10, 0.45),
               1: rng.uniform(-0.03, 0.03),
               2: rng.uniform(-0.45, -0.10)}[view_cls]
    ct = {0: rng.uniform(1.1, 2.2),
          1: rng.uniform(-0.7, 0.7),
          2: rng.uniform(-2.2, -1.1)}[side_cls]
    img = render_trail_view(trail, x, trail.y(x) + ct,
                            trail.heading(x) + yaw_err, hw=hw, rng=rng)
    return img, view_cls, side_cls


from pathlib import Path  # noqa: E402  (kept near its single use)

DEFAULT_TRAILNET_WEIGHTS = (Path(__file__).resolve().parents[2]
                            / "tests/data/trailnet_synth_trained.npz")


def make_real_trailnet(weights_path=None, trail: Optional[Trail] = None, *,
                       device=None):
    """Perception stage running the REAL TrailNet graph: pose ->
    rendered camera view -> the native `TrailNet` in fp32 on ``device``
    (``None`` is the card) -> 6 probabilities."""
    import torch

    from redtail_tpu_torch.models.trailnet import (params_from_numpy,
                                                   params_from_w8_npz)

    net = params_from_numpy(
        params_from_w8_npz(weights_path or DEFAULT_TRAILNET_WEIGHTS),
        device=device)
    trail = trail or Trail()

    def classify(pose: Pose, rng: np.random.RandomState) -> np.ndarray:
        x, y = float(pose.position[0]), float(pose.position[1])
        img = render_trail_view(trail, x, y, quat_yaw(pose.orientation),
                                rng=rng)
        with torch.inference_mode():
            probs = net(torch.from_numpy(img[None]).to(net.device))
        return probs.float().cpu().numpy()[0]

    return classify


def run_sim(steps: int = 600, *, noise: float = 0.1, seed: int = 0,
            trail: Optional[Trail] = None,
            cfg: Optional[ControllerConfig] = None,
            classifier: Optional[Callable] = None) -> dict:
    trail = trail or Trail()
    cfg = cfg or ControllerConfig(linear_speed=1.0, dnn_turn_angle=15.0,
                                  dnn_lateralcorr_angle=15.0,
                                  direction_filter_innov_coeff=0.7)
    rng = np.random.RandomState(seed)
    vehicle = Drone()
    ctl = Controller(vehicle, cfg)
    start = Pose(np.array([0.0, 0.0, 0.0]),
                 yaw_quat(trail.heading(0.0)))
    ctl.set_pose(start)
    ctl.set_fcu_state(FcuState(mode="OFFBOARD", armed=True))
    ctl.arm()
    ctl.step()  # -> Takeoff
    ctl.set_pose(Pose(start.position + np.array([0, 0, 1.5]),
                      start.orientation))
    ctl.step()  # -> Navigating
    assert ctl.state == ControllerState.NAVIGATING
    ctl.on_joystick(JoyCommand(dnn_on=True))

    if classifier is None:
        classifier = lambda pose, rng: virtual_trailnet(  # noqa: E731
            pose, trail, rng, noise=noise)

    xs, cts = [], []
    pose = ctl.current_pose
    for _ in range(steps):
        probs = classifier(pose, rng)
        ctl.on_trailnet(probs)
        ctl.step()
        pose = ctl.goto_pose.copy()   # perfect waypoint tracking
        ctl.set_pose(pose)
        xs.append(float(pose.position[0]))
        cts.append(abs(trail.cross_track(pose.position[0],
                                         pose.position[1])))
    return {
        "distance_x": xs[-1] - xs[0],
        "max_cross_track": max(cts[50:]) if len(cts) > 50 else max(cts),
        "mean_cross_track": float(np.mean(cts[50:])) if len(cts) > 50
        else float(np.mean(cts)),
        "dnn_commands": ctl.dnn_commands,
        "ai_score": ctl.ai_score,
    }


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=600)
    p.add_argument("--noise", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--real-dnn", action="store_true",
                   help="run the real TrailNet graph on rendered camera "
                        "views instead of the analytic classifier")
    p.add_argument("--weights", default=None,
                   help="TrailNet w8 .npz for --real-dnn (default: the "
                        "committed synthetic-trained checkpoint)")
    p.add_argument("--cpu", action="store_true",
                   help="run --real-dnn's TrailNet on the CPU instead of "
                        "the card")
    args = p.parse_args(argv)
    classifier = (make_real_trailnet(args.weights,
                                     device="cpu" if args.cpu else None)
                  if args.real_dnn else None)
    result = run_sim(args.steps, noise=args.noise, seed=args.seed,
                     classifier=classifier)
    result["real_dnn"] = bool(args.real_dnn)
    print(json.dumps(result))
    return 0 if result["max_cross_track"] < 5.0 else 1


if __name__ == "__main__":
    sys.exit(main())
