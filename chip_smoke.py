#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (`redtail_tpu_torch`) on one card.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It needs one card, PyTorch with CUDA and `nvcc`; no network, no cv2, no
ml_dtypes, nothing of JAX. Without a card, or away from the rest of the
repository, it exits non-zero and prints no result. Phases, each fatal:

1. device: the card's name and power limit (nvidia-smi);
2. build: every CUDA kernel of the port, from `redtail_tpu_torch/csrc`;
3. kernel vs plain: each kernel against its plain PyTorch version on the
   card at the main path's shapes and at ragged / D >= W edge cases, both
   layouts; kernel and plain version timed with CUDA events (device
   time: the host enqueues each call while the stream is held busy);
4. slice, card vs CPU: ResNet18-2D at 129x257, max_disp 16, seeded random
   weights: card fp32 (TF32 off) against the CPU (plain corr) within 1e-3,
   and card bf16 against CPU fp32 with a mean abs error under 1e-2;
5. serving: `StereoNode` with ResNet18-2D at the full 321x1025 width, bf16,
   random weights, serving 10 frame pairs; every output finite, in
   [0, 1025] px, and the corr kernel launched once per frame.

Then one JSON line describing every ported kernel, and last the line
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SERVE_FRAMES = 10
TIMING_REPS = 30
HOLD_CYCLES = 20_000_000  # ~10 ms at 1.98 GHz, longer than any enqueue here
FP32_ATOL = 1e-4  # corr at unit-scale inputs: summation order only
# (name, (N, H, W, C), D): the flagship's shape first (the main path's).
CORR_CASES = (("flagship", (1, 161, 513, 32), 48),
              ("ragged", (2, 7, 37, 8), 6),
              ("D>W", (1, 3, 5, 4), 9),
              ("D=W", (1, 4, 6, 8), 6))
# H100 SXM data sheet: HBM bytes/s and fp32 (non-tensor-core) FLOP/s. The
# card's name and power limit are printed beside every number.
PEAK_BYTES, PEAK_FP32_FLOPS = 3.35e12, 67e12


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def print_clocks(after: str) -> None:
    """Informational: clocks, power and temperature right after a timed
    window, to tell one run's card state from another's."""
    print(f"card after {after}: clocks.sm, clocks.max.sm, power.draw, "
          f"temperature.gpu = "
          f"{nvidia_smi('clocks.sm,clocks.max.sm,power.draw,temperature.gpu')}")


def cuda_ms(torch, fn, flush, *, hold=True, reps=TIMING_REPS) -> float:
    """Median time of one call (CUDA events), L2 evicted before each.

    With ``hold`` the stream spins (`torch.cuda._sleep`) ahead of the start
    event while the host enqueues the call, so the time is the device's
    alone. Without it the stream is idle at the start event and the time
    also holds the host's enqueue (Python checks, allocation, launch)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        if hold:
            torch.cuda._sleep(HOLD_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        check(not (hold and start.query()),
              "the hold ended before the call was enqueued: the time would "
              "include the host's; raise HOLD_CYCLES")
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bf16_ulp_ok(torch, got, want, fp32_atol) -> bool:
    """|got - want| <= one bf16 ulp of the larger magnitude, on top of the
    fp32 results' own summation-order tolerance: both sides round an fp32
    sum once, and near zero that sum's order error exceeds an ulp."""
    mag = torch.maximum(got.float().abs(), want.float().abs())
    ulp = torch.exp2(torch.floor(torch.log2(mag.clamp_min(2.0 ** -126))) - 7)
    return bool(((got.float() - want.float()).abs()
                 <= ulp + fp32_atol).all())


def conditioned_params(np, tree, seed):
    """Random biases (zero biases hide boundary bugs) and residual-branch
    and feature-head weights scaled by 0.3: under plain He-init the cost
    volume reaches ~1e4 and the soft-argmax turns fp32 rounding into
    ~5e-4 of output error; scaled, the volume is O(1), as a trained
    network's is."""
    rs = np.random.RandomState(seed)

    def walk(node, path):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v, f"{path}/{k}")
            elif k == "biases":
                out[k] = (rs.randn(*v.shape) * 0.1).astype(np.float32)
            elif path.endswith(("res_conv2", "encoder2D_out")):
                out[k] = (v * 0.3).astype(np.float32)
            else:
                out[k] = v
        return out
    return walk(tree, "")


def phase_kernels(torch, corr, gen):
    """Kernel vs plain at every case, both layouts and dtypes; returns the
    kernel's entry of the `kernels` line (launches filled in later)."""
    max_err = 0.0
    for name, shape, d in CORR_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            left = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            right = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            for layout in ("dlast", "hdw"):
                got = corr.corr_cost_volume(left, right, d, layout=layout)
                torch.cuda.synchronize()
                want = corr.corr_cost_volume_plain(left, right, d,
                                                   layout=layout)
                check(got.shape == want.shape and got.dtype == want.dtype,
                      f"{name} {layout}: {got.shape} {got.dtype} vs "
                      f"{want.shape} {want.dtype}")
                err = (got.float() - want.float()).abs().max().item()
                # unit-scale inputs: only the fp32 summation order differs
                if got.dtype == torch.float32:
                    check(err <= FP32_ATOL, f"corr {name} {dtype} {layout}: "
                          f"max abs err {err} > {FP32_ATOL}")
                    max_err = max(max_err, err)
                    tol = f"{FP32_ATOL}"
                else:
                    check(bf16_ulp_ok(torch, got, want, FP32_ATOL),
                          f"corr {name} {dtype} {layout}: more than one "
                          f"bf16 ulp + {FP32_ATOL} off (max abs err {err})")
                    tol = f"1 bf16 ulp + {FP32_ATOL}"
                print(f"corr {name:8s} {str(shape):18s} D={d:<3d} "
                      f"{str(dtype):15s} {layout:5s} max_abs_err={err:.3e} "
                      f"(tol {tol})")

    # Time the main path's call: flagship, bf16 features, fp32 dlast out.
    _, shape, d = CORR_CASES[0]
    left = torch.randn(shape, generator=gen, device="cuda").bfloat16()
    right = torch.randn(shape, generator=gen, device="cuda").bfloat16()
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    def kernel():
        return corr.corr_cost_volume(left, right, d)

    kernel_ms = cuda_ms(torch, kernel, flush)
    call_ms = cuda_ms(torch, kernel, flush, hold=False)
    plain_ms = cuda_ms(torch, lambda: corr.corr_cost_volume_plain(
        left, right, d), flush)
    print_clocks("the corr timing")
    n, h, w, c = shape
    nbytes = 2 * left.numel() * left.element_size() + n * h * w * d * 4
    flops = 2 * c * n * h * sum(max(w - k, 0) for k in range(d))
    bytes_ms = 1e3 * nbytes / PEAK_BYTES
    flops_ms = 1e3 * flops / PEAK_FP32_FLOPS
    print(f"corr timing at {shape} D={d} bf16 -> fp32 dlast, L2 evicted, "
          f"device time: kernel {kernel_ms:.4f} ms (from an idle stream, "
          f"host enqueue included: {call_ms:.4f} ms), plain "
          f"{plain_ms:.4f} ms; bound "
          f"{max(bytes_ms, flops_ms):.4f} ms ({nbytes / 1e6:.2f} MB at "
          f"{PEAK_BYTES / 1e12} TB/s = {bytes_ms:.4f} ms; "
          f"{flops / 1e9:.3f} GFLOP fp32 at {PEAK_FP32_FLOPS / 1e12} TFLOP/s = "
          f"{flops_ms:.4f} ms)")
    return {"name": "corr_cost_volume", "route": "cuda",
            "source": "redtail_tpu_torch/csrc/corr_cost_volume.cu",
            "replaces": "redtail_tpu/kernels/cost_volume_pallas.py:43",
            "launches": None, "max_abs_err": max_err, "ms": kernel_ms,
            "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, flops_ms),
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
            "library_ms": None}


def phase_slice(np, torch, models, s2d):
    """The model on the card against the same model on the CPU."""
    spec = dataclasses.replace(models.STEREO_SPECS["resnet18_2d"],
                               input_hw=(129, 257), max_disp=16)
    tree = conditioned_params(np, models.init_stereo_params(spec, seed=1), 2)
    rs = np.random.RandomState(3)
    left, right = (torch.from_numpy(s2d(rs.rand(1, 129, 257, 3)
                                        .astype(np.float32)))
                   for _ in range(2))
    with torch.inference_mode():
        ref = models.stereo_forward(spec, tree, left, right).numpy()
        got = {}
        for dtype in (torch.float32, torch.bfloat16):
            net = models.params_from_numpy(spec, tree, dtype=dtype)
            got[dtype] = net(left.cuda(), right.cuda()).float().cpu().numpy()
    check(ref.shape == (1, 129, 257) and np.isfinite(ref).all(),
          f"CPU output {ref.shape} not finite/shaped")
    err32 = np.abs(got[torch.float32] - ref)
    err16 = np.abs(got[torch.bfloat16] - ref)
    print(f"slice 129x257 D=16: card fp32 vs CPU fp32 max abs err "
          f"{err32.max():.3e} (tol 1e-3); card bf16 vs CPU fp32 mean "
          f"{err16.mean():.3e} (gate 1e-2) max {err16.max():.3e}")
    check(err32.max() <= 1e-3, f"card fp32 off CPU by {err32.max()}")
    check(err16.mean() < 1e-2, f"card bf16 off CPU fp32 by mean "
          f"{err16.mean()}")


def phase_serve(np, torch, models, nodes, corr):
    """StereoNode at the flagship's full width, bf16, random weights."""
    hw = (321, 1025)
    spec = dataclasses.replace(models.STEREO_SPECS["resnet18_2d"],
                               input_hw=hw)
    node = nodes.StereoNode(spec, models.init_stereo_params(spec, seed=0),
                            dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    frames = [(rng.integers(0, 256, hw + (3,), dtype=np.uint8),
               rng.integers(0, 256, hw + (3,), dtype=np.uint8))
              for _ in range(SERVE_FRAMES)]
    for _ in range(2):  # warm-up: cuDNN algorithm choice, kernel load
        node(*frames[0])
    node.profiler.reset()
    corr.corr_cost_volume.launches = 0
    lat = []
    for left, right in frames:
        t0 = time.perf_counter()
        disp = node(left, right)  # ends in a copy to the host
        lat.append(1e3 * (time.perf_counter() - t0))
        check(disp.shape == hw and disp.dtype == np.float32,
              f"served {disp.shape} {disp.dtype}")
        check(np.isfinite(disp).all(), "served a non-finite disparity")
        check(disp.min() >= 0 and disp.max() <= hw[1],
              f"disparity outside [0, {hw[1]}]: {disp.min()}..{disp.max()}")
    launches = corr.corr_cost_volume.launches
    print(f"serve resnet18_2d {hw[0]}x{hw[1]} bf16: {SERVE_FRAMES} frames, "
          f"corr launches {launches}, per-frame latency median "
          f"{statistics.median(lat):.3f} ms (min {min(lat):.3f}, max "
          f"{max(lat):.3f}; host clock, synchronized)")
    print_clocks("serving")
    print(node.profiler.report())
    check(launches == SERVE_FRAMES,
          f"corr kernel launched {launches} times for {SERVE_FRAMES} frames")
    trace_frames(torch, node, frames[:3], statistics.median(lat))
    return launches


def trace_frames(torch, node, frames, frame_ms):
    """Informational: device time by kernel over a few served frames
    (`torch.profiler`), and the device's idle share of the unprofiled
    per-frame latency ``frame_ms``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for left, right in frames:
            node(left, right)
    events = prof.key_averages()
    busy_ms = sum(e.self_device_time_total for e in events
                  if e.device_type == DeviceType.CUDA
                  and not e.is_user_annotation) / 1e3 / len(frames)
    if busy_ms == 0:
        print("trace: the profiler recorded no device time")
        return
    print(f"trace over {len(frames)} frames: device busy {busy_ms:.3f} ms "
          f"per frame; idle share {1 - busy_ms / frame_ms:.3f} of the "
          f"{frame_ms:.3f} ms median latency")
    print(events.table(sort_by="self_cuda_time_total", row_limit=12,
                       max_name_column_width=60))


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: this "
                           "smoke test needs an NVIDIA card")
    sys.path.insert(0, str(ROOT))
    try:
        from redtail_tpu_torch import kernels, models, seeded_generator
        from redtail_tpu_torch.kernels import corr_cost_volume as corr
        from redtail_tpu_torch.ops.space_to_depth import space_to_depth2_np
        from redtail_tpu_torch.runtime import nodes
    except ImportError as e:
        raise SmokeFailure(f"redtail_tpu_torch is not beside chip_smoke.py "
                           f"({e})") from e

    print(nvidia_smi("name,power.limit"))
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    libs = kernels.build()
    print(f"build: {len(libs)} kernel(s) in "
          f"{time.perf_counter() - t0:.2f} s")
    for name in libs:
        log = (kernels._build.BUILD / f"{name}.log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {name}: {line.strip()}")

    entry = phase_kernels(torch, corr, seeded_generator(0))
    phase_slice(np, torch, models, space_to_depth2_np)
    entry["launches"] = phase_serve(np, torch, models, nodes, corr)

    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
