#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (`redtail_tpu_torch`) on one card.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It needs one card, PyTorch with CUDA and `nvcc`; no network, no cv2, no
ml_dtypes, nothing of JAX. Without a card, or away from the rest of the
repository, it exits non-zero and prints no result. Phases, each fatal:

1. device: the card's name and power limit (nvidia-smi);
2. build: every CUDA kernel of the port, from `redtail_tpu_torch/csrc`,
   one nvcc per source, all at once;
3. kernel vs plain: each kernel against its plain PyTorch version on the
   card at the main paths' shapes and at edge cases (ragged W, D >= W,
   odd D, C not a multiple of 8), fp32 and bf16; each kernel and its
   plain version timed at the main path's shape with CUDA events (device
   time: the host enqueues each call while the stream is held busy, L2
   evicted before each call);
4. slice, card vs CPU: ResNet18-2D at 129x257 (max_disp 16) and NVTiny,
   NVSmall, ResNet-18 3D at 65x129 (max_disp 8, both lowerings), seeded
   weights: card fp32 (TF32 off) against the CPU within a stated
   tolerance, card bf16 against CPU fp32 under a stated mean;
5. serving, the main paths at full 321x1025 width in bf16, each driven
   with every launch count set to 0 just before and read just after:
   a. `StereoNode` ResNet18-2D, random weights, 10 frames: the corr
      kernel once per frame, disparity in [0, 1025] px;
   b. `StereoNode` NVSmall with the repo's real weights
      (`tests/data/nvsmall_golden.npz`), 10 frames: the fused cost-volume
      assembly kernel once per frame, disparity finite and in [0, 96] px;
   c. one NVSmall frame under `plain_lowering()`: the concat kernel once,
      and the disparity within a stated tolerance of the fused path's on
      the same frame (the two lowerings are the same function).
   Each prints its median latency, the `StageProfiler` report, peak
   device memory and a `torch.profiler` table; NVSmall also a per-layer
   device-time breakdown.

Then one JSON line describing every ported kernel, and last the line
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import contextlib
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
HOLD_CYCLES = 20_000_000  # ~10 ms at 1.98 GHz, longer than a kernel's enqueue
PLAIN_HOLD_CYCLES = 200_000_000  # ~100 ms: a plain version enqueues many ops
FP32_ATOL = 1e-4  # kernels at unit-scale inputs: summation order only
# (name, (N, H, W, C), D): the main path's shape first.
CORR_CASES = (("flagship", (1, 161, 513, 32), 48),
              ("ragged", (2, 7, 37, 8), 6),
              ("D>W", (1, 3, 5, 4), 9),
              ("D=W", (1, 4, 6, 8), 6))
# Concat volume features (N, H, W, C), D / fused-CV assembly maps
# (N, H, W, K), D: NVSmall's shape first, then ResNet-18 3D's, then edges.
CONCAT_CASES = (("nvsmall", (1, 161, 513, 32), 48),
                ("resnet18", (1, 161, 513, 32), 68),
                ("ragged", (2, 7, 37, 8), 6),
                ("D>W", (1, 3, 5, 4), 9),
                ("C=3", (1, 4, 9, 3), 5))
EMIT_CASES = (("nvsmall", (1, 161, 513, 32), 48),
              ("resnet18", (1, 161, 513, 32), 68),
              ("ragged", (2, 7, 37, 8), 6),
              ("odd D", (1, 5, 70, 4), 7),
              ("D>W", (1, 3, 5, 4), 9),
              ("D=1", (1, 3, 9, 3), 1))
FULL_HW = (321, 1025)
SLICE_3D_HW, SLICE_3D_DISP = (65, 129), 8
SLICE_3D_FP32_ATOL = 1e-3   # px: card fp32 vs CPU fp32, summation order
SLICE_3D_BF16_MEAN = 0.1    # px: bf16 weights and activations through the
#                             net, on a 0..16 px output (H100: 0.02-0.034)
# px, fused vs plain lowering on one bf16 frame: the two differ only in
# where conv3D_1 rounds to bf16; on a random-texture pair the matching cost
# is flat at a few pixels, where that rounding moves the soft-argmin by up
# to 1.5 px (H100, two frames: max 0.656 and 1.5, mean 0.0055 and 0.0037)
LOWERINGS_MEAN, LOWERINGS_MAX = 0.02, 4.0
# H100 SXM data sheet: HBM bytes/s, fp32 (non-tensor-core) and dense bf16
# tensor-core FLOP/s. The card's name and power limit are printed beside
# every number.
PEAK_BYTES, PEAK_FP32_FLOPS, PEAK_BF16_FLOPS = 3.35e12, 67e12, 989e12


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


def cuda_ms(torch, fn, flush, *, hold=HOLD_CYCLES, reps=TIMING_REPS) -> float:
    """Median time of one call (CUDA events), L2 evicted before each.

    With ``hold`` cycles the stream spins (`torch.cuda._sleep`) ahead of
    the start event while the host enqueues the call, so the time is the
    device's alone. With ``hold=0`` the stream is idle at the start event
    and the time also holds the host's enqueue (Python checks, allocation,
    launch)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        if hold:
            torch.cuda._sleep(hold)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        check(not (hold and start.query()),
              "the hold ended before the call was enqueued: the time would "
              "include the host's; raise the hold")
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


def bound(nbytes, flops):
    """(bound ms, what bounds it) for ``nbytes`` of HBM traffic and
    ``flops`` fp32 operations."""
    bytes_ms = 1e3 * nbytes / PEAK_BYTES
    flops_ms = 1e3 * flops / PEAK_FP32_FLOPS
    return max(bytes_ms, flops_ms), ("bytes" if bytes_ms >= flops_ms
                                     else "operations")


def time_kernel(torch, name, kernel, plain, nbytes, flops):
    """Kernel and plain version timed at the main path's call; returns the
    timing keys of the kernel's entry of the `kernels` line."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    kernel_ms = cuda_ms(torch, kernel, flush)
    call_ms = cuda_ms(torch, kernel, flush, hold=0)
    plain_ms = cuda_ms(torch, plain, flush, hold=PLAIN_HOLD_CYCLES)
    print_clocks(f"the {name} timing")
    bound_ms, bound_by = bound(nbytes, flops)
    print(f"{name} timing, L2 evicted, device time: kernel {kernel_ms:.4f} ms "
          f"(from an idle stream, host enqueue included: {call_ms:.4f} ms), "
          f"plain {plain_ms:.4f} ms; bound {bound_ms:.4f} ms by {bound_by} "
          f"({nbytes / 1e6:.2f} MB at {PEAK_BYTES / 1e12} TB/s, "
          f"{flops / 1e9:.3f} GFLOP fp32 at {PEAK_FP32_FLOPS / 1e12} TFLOP/s)")
    return {"ms": kernel_ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def _randn(torch, gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def print_conv223_bound():
    """The one TPU kernel not ported yet, `_conv223_kernel`
    (`redtail_tpu/kernels/conv223_pallas.py:60`), has no time here; its
    bound at the call it would take on NVSmall's packed path (conv3D_2,
    `ops/packed3d.py:314-321`, once per frame), worked out from shapes:
    xp (1, 25, 82, 513, 128) x k (2, 2, 3, 128, 128) -> (1, 24, 81, 513,
    128), bf16, dense bf16 multiply-adds on the tensor cores."""
    x, out = 25 * 82 * 513 * 128, 24 * 81 * 513 * 128
    taps = 2 * 2 * 3 * 128
    nbytes = 2 * (x + taps * 128 + out) + 4 * 128
    flops = 2 * out * taps
    bytes_ms = 1e3 * nbytes / PEAK_BYTES
    flops_ms = 1e3 * flops / PEAK_BF16_FLOPS
    print(f"conv223 (not ported) at NVSmall conv3D_2, 1 call per frame on "
          f"the packed path: bound {max(bytes_ms, flops_ms):.4f} ms by "
          f"{'bytes' if bytes_ms >= flops_ms else 'operations'} "
          f"({nbytes / 1e6:.2f} MB at {PEAK_BYTES / 1e12} TB/s = "
          f"{bytes_ms:.4f} ms; {flops / 1e9:.1f} GFLOP bf16 at "
          f"{PEAK_BF16_FLOPS / 1e12} TFLOP/s = {flops_ms:.4f} ms)")


def phase_corr(torch, corr, gen):
    """The corr kernel against its plain version at every case, both
    layouts and dtypes, then timed at the ResNet18-2D call."""
    max_err = 0.0
    for name, shape, d in CORR_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            left, right = (_randn(torch, gen, shape, dtype) for _ in range(2))
            for layout in ("dlast", "hdw"):
                got = corr.corr_cost_volume(left, right, d, layout=layout)
                torch.cuda.synchronize()
                want = corr.corr_cost_volume_plain(left, right, d,
                                                   layout=layout)
                check(got.shape == want.shape and got.dtype == want.dtype,
                      f"corr {name} {layout}: {got.shape} {got.dtype} vs "
                      f"{want.shape} {want.dtype}")
                err = (got.float() - want.float()).abs().max().item()
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

    _, shape, d = CORR_CASES[0]
    left, right = (_randn(torch, gen, shape, torch.bfloat16)
                   for _ in range(2))
    n, h, w, c = shape
    entry = {"name": "corr_cost_volume", "route": "cuda",
             "source": "redtail_tpu_torch/csrc/corr_cost_volume.cu",
             "replaces": "redtail_tpu/kernels/cost_volume_pallas.py:43",
             "launches": None, "max_abs_err": max_err}
    entry.update(time_kernel(
        torch, f"corr at {shape} D={d} bf16 -> fp32 dlast",
        lambda: corr.corr_cost_volume(left, right, d),
        lambda: corr.corr_cost_volume_plain(left, right, d),
        2 * left.numel() * left.element_size() + n * h * w * d * 4,
        2 * c * n * h * sum(max(w - k, 0) for k in range(d))))
    return entry


def phase_concat(torch, concat, gen):
    """The concat kernel against its plain version, bit for bit, then
    timed at NVSmall's plain-lowering call."""
    for name, shape, d in CONCAT_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            left, right = (_randn(torch, gen, shape, dtype) for _ in range(2))
            got = concat.cost_volume_concat(left, right, d)
            torch.cuda.synchronize()
            want = concat.cost_volume_concat_plain(left, right, d)
            check(got.shape == want.shape and got.dtype == want.dtype,
                  f"concat {name}: {got.shape} {got.dtype} vs "
                  f"{want.shape} {want.dtype}")
            err = (got.float() - want.float()).abs().max().item()
            check(torch.equal(got, want),
                  f"concat {name} {dtype}: not bit-exact (max abs err {err})")
            print(f"concat {name:8s} {str(shape):18s} D={d:<3d} "
                  f"{str(dtype):15s} bit-exact (max_abs_err={err:.1e})")
            del got, want

    _, shape, d = CONCAT_CASES[0]
    left, right = (_randn(torch, gen, shape, torch.bfloat16)
                   for _ in range(2))
    n, h, w, c = shape
    entry = {"name": "cost_volume_concat", "route": "cuda",
             "source": "redtail_tpu_torch/csrc/cost_volume_concat.cu",
             "replaces": "redtail_tpu/kernels/cost_volume_pallas.py:158",
             "launches": None, "max_abs_err": 0.0}
    entry.update(time_kernel(
        torch, f"concat at {shape} D={d} bf16",
        lambda: concat.cost_volume_concat(left, right, d),
        lambda: concat.cost_volume_concat_plain(left, right, d),
        2 * left.numel() * 2 + n * d * h * w * 2 * c * 2, 0))
    return entry


def phase_emit(torch, emit, gen):
    """The fused cost-volume assembly kernel against its plain version,
    then timed at NVSmall's serving call."""
    max_err = 0.0
    for name, (n, h, w, k), d in EMIT_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            la = _randn(torch, gen, (n, h, w, 3 * k), dtype)
            rb = _randn(torch, gen, (n, h, w, 6 * k), dtype)
            bias = _randn(torch, gen, (k,), torch.float32)
            got = emit.fused_cv_emit(la, rb, bias, d)
            torch.cuda.synchronize()
            want = emit.fused_cv_emit_plain(la, rb, bias, d)
            check(got.shape == want.shape and got.dtype == want.dtype,
                  f"emit {name}: {got.shape} {got.dtype} vs "
                  f"{want.shape} {want.dtype}")
            err = (got.float() - want.float()).abs().max().item()
            if dtype == torch.float32:
                check(err <= FP32_ATOL, f"emit {name} fp32: max abs err "
                      f"{err} > {FP32_ATOL}")
                max_err = max(max_err, err)
                tol = f"{FP32_ATOL}"
            else:
                check(bf16_ulp_ok(torch, got, want, FP32_ATOL),
                      f"emit {name} bf16: more than one bf16 ulp + "
                      f"{FP32_ATOL} off (max abs err {err})")
                tol = f"1 bf16 ulp + {FP32_ATOL}"
            print(f"emit {name:8s} {str((n, h, w, k)):18s} D={d:<3d} "
                  f"{str(dtype):15s} max_abs_err={err:.3e} (tol {tol})")
            del got, want

    _, (n, h, w, k), d = EMIT_CASES[0]
    la = _randn(torch, gen, (n, h, w, 3 * k), torch.bfloat16)
    rb = _randn(torch, gen, (n, h, w, 6 * k), torch.bfloat16)
    bias = _randn(torch, gen, (k,), torch.float32)
    out = n * d * h * w * k
    entry = {"name": "fused_cv_emit", "route": "cuda",
             "source": "redtail_tpu_torch/csrc/fused_cv_emit.cu",
             "replaces": "redtail_tpu/kernels/fused_cv_emit_pallas.py:65",
             "launches": None, "max_abs_err": max_err}
    # per output: the S add, the bias add and the ELU (exp, select)
    entry.update(time_kernel(
        torch, f"emit at {(n, h, w, k)} D={d} bf16",
        lambda: emit.fused_cv_emit(la, rb, bias, d),
        lambda: emit.fused_cv_emit_plain(la, rb, bias, d),
        (la.numel() + rb.numel()) * 2 + k * 4 + out * 2, 4 * out))
    return entry


def phase_slice(np, torch, models, s2d, plain_lowering):
    """The models on the card against the same models on the CPU."""
    cases = [("resnet18_2d", (129, 257), 16, "fused", 1e-3, 1e-2, "")]
    cases += [(name, SLICE_3D_HW, SLICE_3D_DISP, lowering,
               SLICE_3D_FP32_ATOL, SLICE_3D_BF16_MEAN, " px")
              for name in ("nvtiny", "nvsmall", "resnet18")
              for lowering in ("fused", "plain")]
    for name, hw, max_disp, lowering, atol, mean_gate, unit in cases:
        spec = dataclasses.replace(models.STEREO_SPECS[name], input_hw=hw,
                                   max_disp=max_disp)
        tree = conditioned_params(np, models.init_stereo_params(spec, seed=1),
                                  2)
        rs = np.random.RandomState(3)
        left, right = (torch.from_numpy(s2d(rs.rand(1, *hw, 3)
                                            .astype(np.float32)))
                       for _ in range(2))
        got = {}
        with torch.inference_mode(), (plain_lowering() if lowering == "plain"
                                      else contextlib.nullcontext()):
            ref = models.stereo_forward(spec, tree, left, right).numpy()
            for dtype in (torch.float32, torch.bfloat16):
                net = models.params_from_numpy(spec, tree, dtype=dtype)
                got[dtype] = net(left.cuda(), right.cuda()).float().cpu() \
                    .numpy()
        check(ref.shape == (1, *hw) and np.isfinite(ref).all(),
              f"{name} CPU output {ref.shape} not finite/shaped")
        err32 = np.abs(got[torch.float32] - ref)
        err16 = np.abs(got[torch.bfloat16] - ref)
        print(f"slice {name} {hw[0]}x{hw[1]} D={max_disp} {lowering}: card "
              f"fp32 vs CPU fp32 max abs err {err32.max():.3e}{unit} (tol "
              f"{atol}); card bf16 vs CPU fp32 mean {err16.mean():.3e}{unit} "
              f"(gate {mean_gate}) max {err16.max():.3e}")
        check(err32.max() <= atol, f"{name} {lowering}: card fp32 off CPU "
              f"by {err32.max()}")
        check(err16.mean() < mean_gate, f"{name} {lowering}: card bf16 off "
              f"CPU fp32 by mean {err16.mean()}")


def stereo_frames(np, seed, count):
    """``count`` uint8 BGR frame pairs at the full width: random texture,
    the right frame the left one shifted by a few pixels."""
    rng = np.random.default_rng(seed)
    frames = []
    for i in range(count):
        left = rng.integers(0, 256, FULL_HW + (3,), dtype=np.uint8)
        frames.append((left, np.roll(left, -(4 + 2 * i), axis=1)))
    return frames


def serve(np, torch, node, frames, counters, max_disp_px, label):
    """The main path: every launch count set to 0, ``frames`` served, the
    counts read. Returns (disparities, counts, median latency ms)."""
    for _ in range(2):  # warm-up: cuDNN algorithm choice, kernel load
        node(*frames[0])
    node.profiler.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    lat, outs = [], []
    for left, right in frames:
        t0 = time.perf_counter()
        disp = node(left, right)  # ends in a copy to the host
        lat.append(1e3 * (time.perf_counter() - t0))
        outs.append(disp)
    counts = {c.__name__: c.launches for c in counters}
    for disp in outs:
        check(disp.shape == FULL_HW and disp.dtype == np.float32,
              f"{label}: served {disp.shape} {disp.dtype}")
        check(np.isfinite(disp).all(), f"{label}: a non-finite disparity")
        check(disp.min() >= 0 and disp.max() <= max_disp_px,
              f"{label}: disparity outside [0, {max_disp_px}]: "
              f"{disp.min()}..{disp.max()}")
    med = statistics.median(lat)
    print(f"serve {label}: {len(frames)} frames, launches {counts}, "
          f"per-frame latency median {med:.3f} ms (min {min(lat):.3f}, max "
          f"{max(lat):.3f}; host clock, synchronized); disparity "
          f"{min(d.min() for d in outs):.3f}..{max(d.max() for d in outs):.3f}"
          f" px; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    return outs, counts, med


def phase_serve_2d(np, torch, models, nodes, counters):
    """StereoNode ResNet18-2D at the full width, bf16, random weights."""
    spec = dataclasses.replace(models.STEREO_SPECS["resnet18_2d"],
                               input_hw=FULL_HW)
    node = nodes.StereoNode(spec, models.init_stereo_params(spec, seed=0),
                            dtype=torch.bfloat16)
    frames = stereo_frames(np, 0, SERVE_FRAMES)
    _, counts, med = serve(np, torch, node, frames, counters, FULL_HW[1],
                           "resnet18_2d 321x1025 bf16")
    print_clocks("serving resnet18_2d")
    print(node.profiler.report())
    check(counts["corr_cost_volume"] == SERVE_FRAMES,
          f"corr kernel launched {counts['corr_cost_volume']} times for "
          f"{SERVE_FRAMES} frames")
    trace_frames(torch, node, frames[:3], med)
    return counts["corr_cost_volume"]


def phase_serve_3d(np, torch, models, nodes, counters, plain_lowering):
    """StereoNode NVSmall at the full width, bf16, the repo's real weights;
    then one frame under `plain_lowering()`."""
    spec = models.STEREO_SPECS["nvsmall"]
    check(spec.input_hw == FULL_HW, f"nvsmall spec is {spec.input_hw}")
    tree = models.params_from_npz(ROOT / "tests/data/nvsmall_golden.npz")
    node = nodes.StereoNode(spec, tree, dtype=torch.bfloat16)
    frames = stereo_frames(np, 1, SERVE_FRAMES)
    label = "nvsmall 321x1025 bf16 (tests/data/nvsmall_golden.npz)"
    fused_out, counts, med = serve(np, torch, node, frames, counters,
                                   spec.full_max_disp, label)
    print_clocks("serving nvsmall")
    print(node.profiler.report())
    check(counts["fused_cv_emit"] == SERVE_FRAMES,
          f"emit kernel launched {counts['fused_cv_emit']} times for "
          f"{SERVE_FRAMES} frames")
    check(counts["cost_volume_concat"] == 0,
          "the fused path launched the concat kernel")
    trace_frames(torch, node, frames[:3], med)
    layer_breakdown(torch, node, frames[0])

    with plain_lowering():
        plain_out, plain_counts, _ = serve(
            np, torch, node, frames[:1], counters, spec.full_max_disp,
            "nvsmall 321x1025 bf16 under plain_lowering()")
    check(plain_counts["cost_volume_concat"] == 1,
          f"plain lowering launched the concat kernel "
          f"{plain_counts['cost_volume_concat']} times for one frame")
    check(plain_counts["fused_cv_emit"] == 0,
          "the plain lowering launched the emit kernel")
    diff = np.abs(plain_out[0] - fused_out[0])
    print(f"nvsmall plain vs fused lowering, same frame, bf16: mean abs diff "
          f"{diff.mean():.4e} px (gate {LOWERINGS_MEAN}), max "
          f"{diff.max():.4e} px (gate {LOWERINGS_MAX})")
    check(diff.mean() < LOWERINGS_MEAN and diff.max() < LOWERINGS_MAX,
          "the two lowerings disagree past the gate")
    return counts["fused_cv_emit"], plain_counts["cost_volume_concat"]


def layer_breakdown(torch, node, frame):
    """Informational: device time of each conv layer of one served frame
    (CUDA events around each layer's forward: its TF-SAME pad, the cuDNN
    call and the fp32 bias add; not the ELU after it); "rest" is the rest
    of the frame's span: the cost volume and conv3D_1 assembly, ELU,
    soft-argmin, casts, uploads, and the device's idle time."""
    net = node.net
    spans = []

    def pre(name):
        def hook(_mod, _args):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            spans.append([name, e, None])
        return hook

    def post(_mod, _args, _out):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        spans[-1][2] = e

    handles = []
    for name, mod in net.named_modules():
        if hasattr(mod, "weight") and not list(mod.children()):
            handles.append(mod.register_forward_pre_hook(pre(name)))
            handles.append(mod.register_forward_hook(post))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    try:
        start.record()
        node(*frame)
        end.record()
        end.synchronize()
    finally:
        for h in handles:
            h.remove()
    total = start.elapsed_time(end)
    rows = [(name, s.elapsed_time(e)) for name, s, e in spans]
    print(f"per-layer device time, one nvsmall frame ({total:.3f} ms from "
          f"the first upload to the last copy):")
    for name, ms in rows:
        print(f"  {name:32s} {ms:8.3f} ms")
    print(f"  {'rest':32s} {total - sum(ms for _, ms in rows):8.3f} ms "
          f"(other device work, and the device idle while the host packs)")


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
    print(events.table(sort_by="self_cuda_time_total", row_limit=15,
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
        from redtail_tpu_torch.kernels import cost_volume_concat as concat
        from redtail_tpu_torch.kernels import fused_cv_emit as emit
        from redtail_tpu_torch.ops.convolution import plain_lowering
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

    gen = seeded_generator(0)
    entries = {"corr_cost_volume": phase_corr(torch, corr, gen),
               "cost_volume_concat": phase_concat(torch, concat, gen),
               "fused_cv_emit": phase_emit(torch, emit, gen)}
    print_conv223_bound()
    phase_slice(np, torch, models, space_to_depth2_np, plain_lowering)
    counters = (corr.corr_cost_volume, concat.cost_volume_concat,
                emit.fused_cv_emit)
    entries["corr_cost_volume"]["launches"] = phase_serve_2d(
        np, torch, models, nodes, counters)
    (entries["fused_cv_emit"]["launches"],
     entries["cost_volume_concat"]["launches"]) = phase_serve_3d(
        np, torch, models, nodes, counters, plain_lowering)

    print(json.dumps({"kernels": list(entries.values())}))
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
