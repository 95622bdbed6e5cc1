#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (`redtail_tpu_torch`) on one card.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It needs one card, PyTorch with CUDA, `nvcc`, `g++` and, for phase 7e,
cv2; no network, no ml_dtypes, nothing of JAX. Without a card, or away from the rest of the
repository, it exits non-zero and prints no result. Phases, each fatal:

1. device: the card's name and power limit (nvidia-smi);
2. build: every CUDA kernel of the port, from `redtail_tpu_torch/csrc`,
   one nvcc per source, all at once;
3. kernel vs plain: each kernel against its plain PyTorch version on the
   card at the main paths' shapes and at edge cases (ragged W, D >= W,
   odd D, C or K not a multiple of 8, batch 2, W < 8, C = K = 16, K = 64;
   the corr kernel's tile edges: W = 63, 64, 65, 513, D = 1, 47, 48, 49,
   130, C = 3, 8, 40; conv223's tile edges: W = 63, 64, 65, 257, Hout not
   a multiple of 4, K = 16..144 with C != K, more tiles than SMs), fp32
   and bf16, the corr kernel in its three epilogues (the volume in both
   layouts and the fused soft-argmax, the latter on inputs scaled by
   1/sqrt(C) so the volume is O(1), with the unit-scale error printed),
   the fused cost-volume assembly in both its layouts; each kernel and its
   plain version timed at the main path's shape with CUDA events (device
   time: the host enqueues each call while the stream is held busy, L2
   evicted before each call), with its bound share (bound / kernel time);
   the assembly also without its ELU (what the fp32 expm1f costs); the
   corr kernel in each epilogue, the pair the fused one replaces (the
   volume kernel, then `ops/softargmax.py`) and, as the floor under every
   time, one empty kernel timed the same way;
   conv223 (weights in the K-major form the packed head holds) also beside
   cuDNN's `F.conv3d` of the same dense conv (its library yardstick);
4. slice, card vs CPU: ResNet18-2D at 129x257 (max_disp 16) and NVTiny,
   NVSmall, ResNet-18 3D at 65x129 (max_disp 8; the fused, plain and
   packed lowerings, the packed one with the D-folded final deconv on the
   card and the unpack branch on the CPU), seeded weights: card fp32
   (TF32 off) against the CPU within a stated tolerance, card bf16
   against CPU fp32 under a stated mean;
5. serving, the main paths at full 321x1025 width in bf16, each driven
   with every launch count set to 0 just before and read just after:
   a. `StereoNode` ResNet18-2D, random weights, 10 frames: the corr
      kernel's fused soft-argmax once per frame and its volume epilogues
      never, disparity in [0, 1025] px;
   b. `StereoNode` NVSmall with the repo's real weights
      (`tests/data/nvsmall_golden.npz`), 10 frames: the fused cost-volume
      assembly kernel once per frame, disparity finite and in [0, 96] px;
   c. one NVSmall frame under `plain_lowering()`: the concat kernel once,
      and the disparity within a stated tolerance of the fused path's on
      the same frame (the two lowerings are the same function);
   d. `StereoNode` NVSmall, the same weights, under `packed3d_lowering()`,
      10 frames: conv223 and the packed emission once per frame, the concat
      kernel never, and the disparity within a stated gate of the fused
      path's on the same frames.
   Each prints its median latency, the `StageProfiler` report, peak
   device memory and a `torch.profiler` table; NVSmall also a per-layer
   device-time breakdown (5d's covers the packed layers and the D-folded
   deconv3D_3).
6. TrailNet and YOLO, which run no kernel of the port (cuDNN and stock
   PyTorch only): the four kernels' launch counters are printed on lines
   of their own before and after, and must not move.
   a. TrailNet at its full 180x320 with the repo's trained w8 weights
      (`tests/data/trailnet_synth_trained.npz`), both forms (`CaffeNet` over
      the emitted prototxt, the native `TrailNet`): card fp32 (TF32 off)
      against the CPU within 1e-4 on the six probabilities, card bf16
      against CPU fp32 under a mean of 1e-2;
   b. `TrailNetNode` serving 20 frames after 2 warm-up frames, fp32 (the
      JAX package's default) and bf16, each form: median and mean latency,
      device busy per frame and kernel launches per frame from
      `torch.profiler` over 3 more frames, idle share, peak device memory;
   c. `YoloNode` on a YOLO-shaped stand-in graph written here (448x448 ->
      1470, random weights from a seed; not the YOLO model, and no number
      of it is YOLO's): the card's raw head against the CPU's, and the
      (n, 6) detections' contract.

7. the serving runtime (frames in flight on the nodes' CUDA streams, the
   u16 wire, the node graph, the controller and MAVLink, the native pack),
   each path driven with every launch count set to 0 just before and read
   just after:
   a. the native host runtime built from `native/redtail_native.cpp` into
      `redtail_tpu_torch/build/`, and its s2d pack of a 321x1025 frame
      bit-equal to `space_to_depth2_np`, both timed on the host;
   b. `StereoNode` ResNet18-2D at 321x1025 bf16, 20 seeded frames, with
      overlap 0, 1 and 2, in a process of its own that no profiler has
      traced (the script runs itself with `--overlap-child`), each mode
      twice, in turns: call k returns frame k - N under its own stamp,
      bit-equal to the synchronous node; frames/s, the stamp-to-result
      latency median and the device idle share of each;
   c. overlap 1, microbatch 2: ResNet18-2D at full width, and NVTiny at
      65x129 under the fused head and under `packed3d_lowering()`, within
      the bf16 gates of the synchronous node, the corr kernel, the
      emission and conv223 launched once per batch of two;
   d. the u16 wire against f32 on 7b's frames: within 1/128 px below
      1023.984375 px and saturated there above it, the clipped pixels
      counted;
   e. `pipeline_app.main` in this process for 8 s: synthetic 321x1025
      cameras, ResNet18-2D bf16 with overlap 1, TrailNet (`CaffeNet` over
      the emitted prototxt, random weights) at 30 Hz, the YOLO stand-in at
      1 Hz, the controller with `--fcu mavlink` (an in-process autopilot
      over UDP on the loopback interface) and a person-stop at 3.5 s; its
      JSON summary must show frames from stereo, TrailNet and the
      controller, no node error, a stop event, an armed FCU with no bad
      CRC, the corr kernel at least once per stereo frame and the native
      pack on every frame;
   f. `sim_app.main(["--real-dnn"])`, TrailNet on the card in the closed
      loop: exit 0 (max cross-track < 5 m).

8. real weights in, quantized rungs out:
   a. NVSmall's real weights written as fp32 and fp16 TRT blobs
      (`io.write_trt_weights`), loaded back with `params_from_trt_blob` and
      served through `StereoNode` at 321x1025 in fp32 (TF32 off, cuDNN's
      deterministic algorithms) on one frame: the fp32 blob bit-equal to
      the .npz net, the fp16 one within a stated gate;
   b. in a process of its own that no profiler has traced (the script
      runs itself with `--rungs-child`): `StereoNode` in bf16 with quantize
      None / w8 / int8 (int8 calibrated on the first pair) for ResNet18-2D
      (random conditioned weights) and NVSmall (real weights) under the
      fused and the packed head, 20 frames after 2 warm-up frames, the
      counts zeroed just before and read just after: median latency, the
      corr / emission / conv223 launches, D1 and EPE against the same
      model's fp32 node; then each node traced for device busy and idle
      share;
   c. card against CPU on the same seeded inputs and scales: `conv2d_int8`
      and `quantize_act` bit-equal on both routes (K below and above the
      2**24 bound); int8 ResNet18-2D at 129x257 and NVTiny at 65x129 within
      stated gates; the bf16 round-once convs within one bf16 step; conv223
      and the emission shown to add their bias before their one rounding;
   d. `python -m redtail_tpu_torch.apps.stereo_app nvsmall --weights <fp16
      blob> --weights-dtype fp16 --dtype bf16 --quantize int8 --accuracy
      <8a's fp32 disparity .npy> --hw 321 1025` on 8a's pair (written as
      PNGs): exit 0 and the five rungs' rows;
   e. the device busy per frame of each stereo model after the round-once
      repair (8b's unquantized rung) beside the figures before it.

9. training (each path driven with every launch count set to 0 just
   before and read just after):
   a. the backward kernels against their plain versions: the corr backward
      (the fused soft-argmax's, which recomputes the volume, and both
      volume layouts') at ResNet18-2D's training features (4, 80, 256,
      32), D = 48, and at phase 3's corr edges; the concat backward at
      NVTiny's and NVSmall's training features and the concat edges; fp32
      and bf16; each timed at the training call (CUDA events, L2 evicted,
      the stream held busy) beside its bound and its plain version (no
      single PyTorch call computes either);
   b. one train step, card against CPU, fp32 and bf16, ResNet18-2D and
      NVTiny at 64x128, batch 2, the same numpy params: the loss and every
      gradient leaf within stated gates, the backward kernel once;
   c. the main path: `train_app stereo --crop 160x512 --batch 4 --dtype
      bfloat16`, 20 steps of ResNet18-2D (the corr kernel's fused
      soft-argmax and its backward each step), then NVTiny (the concat
      kernel and its backward), on a synthetic KITTI tree written under
      `redtail_tpu_torch/build/smoke/train/`: finite losses, the loss on a
      fixed batch lower after than before, `--resume` for 2 more steps,
      the `--out` params served by `StereoNode`; then `train_app trailnet`
      at 180x320, batch 16, no kernel launched, `--export-caffe`, served
      by `TrailNetNode`; for each, the step's median time, device busy,
      idle share and peak device memory.

10. layer profiling and serialized engines, each path driven with every
    launch count set to 0 just before and read just after:
    a. `stereo_app --profile-layers` in this process on ResNet18-2D bf16 at
       321x1025 (random conditioned weights, s2d frames) and on NVSmall
       bf16 at 321x1025 with the repo's real weights under the packed head:
       the plan check passes on the card, the tables (the sum of the layers
       and the eager end-to-end figure among their lines) printed beside the
       card's name and power limit, and each kernel's row launched its
       kernel;
    b. five engines built by `stereo_app --save-engine` (the pristine
       builder, `runtime/engine_builder.py`), the five apps at once, each in
       a process of its own (`--app-child`): ResNet18-2D bf16 at 321x1025
       on s2d frames (the corr kernel), NVSmall bf16 at 321x1025 with the
       real weights under the fused head (the emission) and under the
       packed head (the packed emission and conv223), NVTiny fp32 at 65x129
       under `plain_lowering()` (the concat kernel), and ResNet18-2D int8
       at 129x257; a fresh process for each (the script runs itself with
       `--engine-child`, the five at once, timed one at a time) runs it
       with `stereo_app --engine`'s flow, imports no model module and
       counts each expected kernel at least once; each engine's disparity
       against the eager model's on the same pair (fp32 within 1e-4 px,
       bf16 within the gates of phases 4 and 5d), with the export and
       compile seconds, package size, load and first-call ms, and the
       engine's and the eager model's device time a frame and synced host
       time a call printed.

Then one JSON line describing every ported kernel, and last the line
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import io as stdio
import json
import re
import shutil
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
# index units: the corr kernel's fused soft-argmax at inputs scaled by
# 1/sqrt(C), the volume's summation order through the softmax
SOFTARGMAX_ATOL = 1e-4
# (name, (N, H, W, C), D): the main path's shape first, then the corr
# kernel's edges: its 16-column warps (W = 63, 64, 65, 513 end in a ragged
# warp), chunks of 64 disparities (D = 1, 47, 48, 49 on 8 y tiles, 130 in
# three chunks), channel steps (C = 40 bf16 takes two 32-channel steps; C =
# 3 is loaded element by element), D > W.
CORR_CASES = (("flagship", (1, 161, 513, 32), 48),
              ("ragged", (2, 7, 37, 8), 6),
              ("D>W", (1, 3, 5, 4), 9),
              ("D=W", (1, 4, 6, 8), 6),
              ("W=63 D=47", (1, 3, 63, 32), 47),
              ("W=64 D=48", (1, 3, 64, 32), 48),
              ("W=65 D=49", (1, 3, 65, 32), 49),
              ("W=513 D=1", (1, 2, 513, 32), 1),
              ("b2 C=8", (2, 3, 65, 8), 48),
              ("D>W b2", (2, 2, 20, 8), 33),
              ("C=40", (1, 2, 33, 40), 9),
              ("C=3", (1, 2, 9, 3), 5),
              ("D=130", (1, 2, 70, 16), 130))
# Concat volume features (N, H, W, C), D / fused-CV assembly maps
# (N, H, W, K), D: NVSmall's shape first, then ResNet-18 3D's, then edges.
CONCAT_CASES = (("nvsmall", (1, 161, 513, 32), 48),
                ("resnet18", (1, 161, 513, 32), 68),
                ("ragged", (2, 7, 37, 8), 6),
                ("D>W", (1, 3, 5, 4), 9),
                ("C=3", (1, 4, 9, 3), 5))
EMIT_CASES = (("nvsmall", (1, 161, 513, 32), 48),
              ("resnet18", (1, 161, 513, 32), 68),
              ("K=64", (1, 9, 513, 64), 48),
              ("ragged", (2, 7, 37, 8), 6),
              ("odd D", (1, 5, 70, 4), 7),
              ("K=12", (1, 5, 33, 12), 7),
              ("b2 odd D", (2, 6, 70, 64), 11),
              ("D>=W b2", (2, 5, 40, 32), 48),
              ("D>W", (1, 3, 5, 4), 9),
              ("D=1", (1, 3, 9, 3), 1))
# conv223 (name, xp (N, Dp, Hp, W, C), K): NVSmall's conv3D_2 first (the
# main path's call), ResNet-18 3D's conv3D_1b, NVTiny's conv3D_2, edges of
# the bf16 kernel's 4 x 64 tiles (W = 63, 64, 65; Hout not a multiple of
# 4; K = 16..144 with C != K; more tiles than 2 x 132 SMs, so the
# persistent loop wraps).
CONV223_CASES = (("nvsmall", (1, 25, 82, 513, 128), 128),
                 ("resnet18", (1, 35, 82, 513, 128), 128),
                 ("nvtiny", (1, 13, 42, 257, 64), 64),
                 ("batch 2", (2, 4, 6, 20, 32), 32),
                 ("odd Hp, Dp", (1, 5, 7, 9, 16), 16),
                 ("W<8", (1, 3, 4, 5, 16), 16),
                 ("C=K=16", (1, 4, 5, 33, 16), 16),
                 ("W=63 K=16", (1, 3, 6, 63, 32), 16),
                 ("W=64 K=32", (1, 3, 6, 64, 64), 32),
                 ("W=65 K=64", (1, 3, 6, 65, 16), 64),
                 ("W=257 K=128", (1, 3, 7, 257, 32), 128),
                 ("b2 K=128", (2, 3, 9, 130, 64), 128),
                 ("K=144", (1, 2, 3, 65, 64), 144),
                 ("wraps", (1, 9, 42, 200, 32), 16))
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
# px, packed vs fused head on the same 10 bf16 frames: the two heads are
# one function and differ in where bf16 rounds (conv223 rounds once where
# cuDNN rounds twice; dfold sums deconv3D_3 in another order), which moves
# the soft-argmin of the flat random-texture costs as the plain lowering
# does (NVIDIA H100 80GB HBM3 at 700 W, one run: per-frame mean
# 0.0020-0.0072 px, max 0.19-2.0 px, mean over the frames 0.0039 px); the
# same gates as the plain lowering's, about 2x the measured maximum
PACKED_MEAN, PACKED_MAX = 0.02, 4.0
TRAILNET_W8 = "tests/data/trailnet_synth_trained.npz"
TRAILNET_FRAMES = 20
TRAILNET_FP32_ATOL = 1e-4   # probabilities: card fp32 (TF32 off) vs CPU fp32
TRAILNET_BF16_MEAN = 1e-2   # probabilities: card bf16 vs CPU fp32
YOLO_STANDIN_WIDTHS = (16, 32, 64, 32)
OVERLAP_FRAMES = 20
OVERLAP_MODES = (0, 1, 2)
OVERLAP_CHILD = "--overlap-child"  # chip_smoke runs itself so for 7b
MB_3D_FRAMES = 8
# 7c, ResNet18-2D at microbatch 2 against the synchronous node, sigmoid
# units, on the pixels whose bf16 sigmoid is below 1: on the random weights
# about half the pixels are pinned at 1.0 (1024 px) whatever the input, so
# a fault that mixed up the two frames of a batch would show only on the
# others (NVIDIA H100 80GB HBM3 at 700 W, one run: mean 5.4e-5 over all
# pixels); the gate needs at least this share of pixels below the pin
MB_2D_MEAN, MB_2D_FREE_SHARE = 1e-3, 0.25
PIPELINE_SECONDS = 8.0
# The injected person rides YOLO's latest-wins output topic, so a YOLO
# publish within one objstop period (50 ms) after it overwrites it; YOLO
# publishes at ~1 s intervals from the start, so inject half-way between.
PERSON_STOP_S = 3.5
# the u16 wire's steps: round(disp * 64), so within half a step of the
# float32 disparity, and saturated at 65535 / 64 px
U16_ATOL, U16_MAX_PX = 1.0 / 128.0, 65535.0 / 64.0
NVSMALL_NPZ = "tests/data/nvsmall_golden.npz"
SMOKE_DIR = ROOT / "redtail_tpu_torch" / "build" / "smoke"
# px, 8a: NVSmall at 321x1025 in fp32 from its weights rounded to fp16 (a
# relative step of 2**-11) against the fp32 .npz weights, on one random-
# texture frame, whose flat matching costs let the soft-argmin move (the
# gates of the bf16 lowering comparisons above)
BLOB_FP16_MEAN, BLOB_FP16_MAX = 0.02, 4.0
RUNGS = (None, "w8", "int8")
RUNG_FRAMES = 20
RUNGS_CHILD = "--rungs-child"  # chip_smoke runs itself so for 8b
# 8b: each rung against its model's fp32 node on the same 20 frames, gated
# at a few times what it read (NVIDIA H100 80GB HBM3 at 700 W): NVSmall
# (fused and packed alike, real weights) EPE px and D1 %, equal to these
# digits in three runs, the EPE gate 3x, the D1 gate 10x (a reading of
# 0.0001 % is one pixel in 329,025); ResNet18-2D (random weights, one run)
# in sigmoid units on the pixels whose bf16 sigmoid is below 1, as 7c
# (0.5846 of them; the rest sit pinned at 1.0 whatever the input): the
# mean error 3x, the share of pixels off by more than 0.01 2x
RUNG_READINGS = {
    "nvsmall": {None: (0.0349, 0.0001), "w8": (0.0396, 0.0086),
                "int8": (0.0669, 0.1135)},
    "resnet18_2d": {None: (3.8491e-3, 0.11920), "w8": (8.9598e-3, 0.19588),
                    "int8": (8.8465e-3, 0.18709)}}
RUNG_EPE_FACTOR, RUNG_D1_FACTOR = 3.0, 10.0
RUNG_2D_MEAN_FACTOR, RUNG_2D_OFF_FACTOR = 3.0, 2.0
RUNG_2D_FREE_SHARE = 0.25
# 8c: int8 nets card vs CPU fp32, (card fp32 mean, card bf16 mean): a
# quantized input within fp32 noise of a rounding boundary may take the
# other step on the card, so the fp32 gate is a mean, 10x the fp32 slice
# gates above; the bf16 ones are the slice gates
INT8_2D_GATES = (1e-3, 1e-2)   # sigmoid units
INT8_3D_GATES = (1e-2, SLICE_3D_BF16_MEAN)  # px
# 8c: the bf16 round-once convs card vs CPU (ops/convolution.py name, x,
# w, keywords): NVSmall's conv2 and conv3D_2-sized 2D and 3D convs and
# deconv3D_1 / 2-sized transposes
ROUND_ONCE_CASES = (
    ("conv2d", (2, 161, 513, 32), (3, 3, 32, 32), {}),
    ("conv3d", (1, 25, 41, 129, 32), (3, 3, 3, 32, 32), {}),
    ("conv2d_transpose", (1, 41, 129, 64), (3, 3, 32, 64),
     {"out_spatial": (81, 257)}),
    ("conv3d_transpose", (1, 13, 21, 65, 64), (3, 3, 3, 32, 64),
     {"out_spatial": (25, 41, 129)}))
# 8c: the epilogues of conv223 (NVSmall's conv3D_2: xp, K) and of the
# emission (NVSmall's: (N, H, W), K, D)
EPILOGUE_CONV223 = ((1, 25, 82, 513, 128), 128)
EPILOGUE_EMIT = ((1, 161, 513), 32, 48)
# device busy per frame, ms, that phases 5a, 5b and 5d measured before the
# bf16 stereo convs rounded once (NVIDIA H100 80GB HBM3 at 700 W)
BEFORE_REPAIR_BUSY_MS = {"resnet18_2d": 1.993, "nvsmall fused": 28.441,
               "nvsmall packed": 9.535}
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


def cuda_ms(torch, fn, flush, *, hold=HOLD_CYCLES, reps=TIMING_REPS,
            label="call") -> float:
    """Median time of one call (CUDA events), L2 evicted before each.

    With ``hold`` cycles the stream spins (`torch.cuda._sleep`) ahead of
    the start event while the host enqueues the call, so the time is the
    device's alone; a rep whose hold ran out first (the host stalled) is
    discarded and taken again, at most 3 times in a row. With ``hold=0``
    the stream is idle at the start event and the time also holds the
    host's enqueue (Python checks, allocation, launch)."""
    for _ in range(3):
        fn()
    times, stalls, in_row = [], 0, 0
    while len(times) < reps:
        flush.zero_()
        if hold:
            torch.cuda._sleep(hold)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        if hold and start.query():
            stalls, in_row = stalls + 1, in_row + 1
            check(in_row <= 3, f"{label}: the hold ended before the call "
                  f"was enqueued {in_row} times in a row: the time would "
                  f"include the host's; raise the hold")
            end.synchronize()
            continue
        in_row = 0
        end.synchronize()
        times.append(start.elapsed_time(end))
    if stalls:
        print(f"{label}: {stalls} rep(s) discarded, the hold ran out before "
              f"the call was enqueued")
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


def bound(nbytes, flops, peak_flops=PEAK_FP32_FLOPS):
    """(bound ms, what bounds it) for ``nbytes`` of HBM traffic and
    ``flops`` operations at ``peak_flops``."""
    bytes_ms = 1e3 * nbytes / PEAK_BYTES
    flops_ms = 1e3 * flops / peak_flops
    return max(bytes_ms, flops_ms), ("bytes" if bytes_ms >= flops_ms
                                     else "operations")


def time_kernel(torch, name, kernel, plain, nbytes, flops, *, library=None,
                peak_flops=PEAK_FP32_FLOPS):
    """Kernel, plain version and (where one PyTorch call computes the same
    function) ``library`` timed at the main path's call; returns the timing
    keys of the kernel's entry of the `kernels` line."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    kernel_ms = cuda_ms(torch, kernel, flush, label=f"{name} kernel")
    call_ms = cuda_ms(torch, kernel, flush, hold=0)
    plain_ms = cuda_ms(torch, plain, flush, hold=PLAIN_HOLD_CYCLES,
                       label=f"{name} plain")
    library_ms = None if library is None else cuda_ms(
        torch, library, flush, label=f"{name} library")
    print_clocks(f"the {name} timing")
    bound_ms, bound_by = bound(nbytes, flops, peak_flops)
    kind = "fp32" if peak_flops == PEAK_FP32_FLOPS else "bf16 tensor-core"
    lib = "" if library_ms is None else f", library {library_ms:.4f} ms"
    print(f"{name} timing, L2 evicted, device time: kernel {kernel_ms:.4f} ms "
          f"(from an idle stream, host enqueue included: {call_ms:.4f} ms), "
          f"plain {plain_ms:.4f} ms{lib}; bound {bound_ms:.4f} ms by "
          f"{bound_by} ({nbytes / 1e6:.2f} MB at {PEAK_BYTES / 1e12} TB/s = "
          f"{1e3 * nbytes / PEAK_BYTES:.4f} ms, {flops / 1e9:.3f} GFLOP "
          f"{kind} at {peak_flops / 1e12} TFLOP/s = "
          f"{1e3 * flops / peak_flops:.4f} ms); bound share (bound / kernel) "
          f"{bound_ms / kernel_ms:.3f}")
    return {"ms": kernel_ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": bound_ms / kernel_ms, "library_ms": library_ms}


def _randn(torch, gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def phase_corr(torch, corr, softargmax, gen):
    """The corr kernel against its plain version at every case, both
    dtypes, in its three epilogues; then each epilogue timed at the
    ResNet18-2D call, beside the unfused pair the fused one replaces."""
    max_err = {"dlast": 0.0, "hdw": 0.0, "softargmax": 0.0}
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
                    max_err[layout] = max(max_err[layout], err)
                    tol = f"{FP32_ATOL}"
                else:
                    check(bf16_ulp_ok(torch, got, want, FP32_ATOL),
                          f"corr {name} {dtype} {layout}: more than one "
                          f"bf16 ulp + {FP32_ATOL} off (max abs err {err})")
                    tol = f"1 bf16 ulp + {FP32_ATOL}"
                print(f"corr {name:10s} {str(shape):18s} D={d:<3d} "
                      f"{str(dtype):15s} {layout:10s} max_abs_err={err:.3e} "
                      f"(tol {tol})")
            errs = {}
            for scale in ("scaled", "unit"):
                lr = (left, right) if scale == "unit" else \
                    tuple(t * shape[-1] ** -0.5 for t in (left, right))
                got = corr.corr_softargmax(*lr, d)
                torch.cuda.synchronize()
                want = corr.corr_softargmax_plain(*lr, d)
                check(got.shape == want.shape == shape[:3]
                      and got.dtype == want.dtype == torch.float32,
                      f"corr {name} softargmax: {got.shape} {got.dtype} vs "
                      f"{want.shape} {want.dtype}")
                errs[scale] = (got - want).abs().max().item()
            check(errs["scaled"] <= SOFTARGMAX_ATOL,
                  f"corr {name} {dtype} softargmax: max abs err "
                  f"{errs['scaled']} > {SOFTARGMAX_ATOL}")
            max_err["softargmax"] = max(max_err["softargmax"], errs["scaled"])
            print(f"corr {name:10s} {str(shape):18s} D={d:<3d} "
                  f"{str(dtype):15s} softargmax max_abs_err="
                  f"{errs['scaled']:.3e} (inputs / sqrt(C); tol "
                  f"{SOFTARGMAX_ATOL}), {errs['unit']:.3e} at unit scale "
                  f"(informational)")

    _, shape, d = CORR_CASES[0]
    left, right = (_randn(torch, gen, shape, torch.bfloat16)
                   for _ in range(2))
    n, h, w, c = shape
    feats = 2 * left.numel() * left.element_size()
    vol = n * h * w * d
    flops = 2 * c * n * h * sum(max(w - k, 0) for k in range(d))
    modes = []
    for mode, out_bytes, kernel, plain in (
            ("softargmax", n * h * w * 4,
             lambda: corr.corr_softargmax(left, right, d),
             lambda: corr.corr_softargmax_plain(left, right, d)),
            ("dlast", vol * 4,
             lambda: corr.corr_cost_volume(left, right, d),
             lambda: corr.corr_cost_volume_plain(left, right, d)),
            ("hdw", vol * 2,
             lambda: corr.corr_cost_volume(left, right, d, layout="hdw"),
             lambda: corr.corr_cost_volume_plain(left, right, d,
                                                 layout="hdw"))):
        # bf16 products on tensor cores; the bytes bound every epilogue
        timed = time_kernel(torch, f"corr {mode} at {shape} D={d} bf16",
                            kernel, plain, feats + out_bytes, flops,
                            peak_flops=PEAK_BF16_FLOPS)
        modes.append({"mode": mode, "max_abs_err": max_err[mode], **timed})
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    unfused_ms = cuda_ms(torch, lambda: softargmax(
        corr.corr_cost_volume(left, right, d), axis=-1), flush,
        label="corr unfused pair")
    # what this timing gives a kernel that does nothing: the floor under
    # every time above
    floor_ms = cuda_ms(torch, lambda: torch.cuda._sleep(0), flush,
                       label="empty kernel")
    print(f"corr softargmax at {shape} D={d} bf16, device time: fused "
          f"{modes[0]['ms']:.4f} ms; the pair it replaces (volume kernel, "
          f"then ops/softargmax.py) {unfused_ms:.4f} ms; one empty kernel "
          f"timed the same way {floor_ms:.4f} ms")
    entry = {"name": "corr_cost_volume", "route": "cuda",
             "source": "redtail_tpu_torch/csrc/corr_cost_volume.cu",
             "replaces": "redtail_tpu/kernels/cost_volume_pallas.py:43",
             "launches": None, "max_abs_err": max_err["softargmax"]}
    # the top-level times are the main path's epilogue's (softargmax)
    entry.update({k: v for k, v in modes[0].items()
                  if k not in ("mode", "max_abs_err")})
    entry.update({"unfused_ms": unfused_ms, "floor_ms": floor_ms,
                  "modes": modes})
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
    """The fused cost-volume assembly kernel against its plain version in
    both layouts, then each layout timed at NVSmall's serving call."""
    max_err = 0.0
    for layout in ("full", "dh_shifted"):
        for name, (n, h, w, k), d in EMIT_CASES:
            for dtype in (torch.bfloat16, torch.float32):
                la = _randn(torch, gen, (n, h, w, 3 * k), dtype)
                rb = _randn(torch, gen, (n, h, w, 6 * k), dtype)
                bias = _randn(torch, gen, (k,), torch.float32)
                got = emit.fused_cv_emit(la, rb, bias, d, layout=layout)
                torch.cuda.synchronize()
                want = emit.fused_cv_emit_plain(la, rb, bias, d,
                                                layout=layout)
                check(got.shape == want.shape and got.dtype == want.dtype,
                      f"emit {layout} {name}: {got.shape} {got.dtype} vs "
                      f"{want.shape} {want.dtype}")
                err = (got.float() - want.float()).abs().max().item()
                if dtype == torch.float32:
                    check(err <= FP32_ATOL, f"emit {layout} {name} fp32: "
                          f"max abs err {err} > {FP32_ATOL}")
                    max_err = max(max_err, err)
                    tol = f"{FP32_ATOL}"
                else:
                    check(bf16_ulp_ok(torch, got, want, FP32_ATOL),
                          f"emit {layout} {name} bf16: more than one bf16 "
                          f"ulp + {FP32_ATOL} off (max abs err {err})")
                    tol = f"1 bf16 ulp + {FP32_ATOL}"
                print(f"emit {layout:10s} {name:8s} {str((n, h, w, k)):18s} "
                      f"D={d:<3d} {str(dtype):15s} max_abs_err={err:.3e} "
                      f"(tol {tol})")
                del got, want

    _, (n, h, w, k), d = EMIT_CASES[0]
    la = _randn(torch, gen, (n, h, w, 3 * k), torch.bfloat16)
    rb = _randn(torch, gen, (n, h, w, 6 * k), torch.bfloat16)
    bias = _randn(torch, gen, (k,), torch.float32)
    entry = {"name": "fused_cv_emit", "route": "cuda",
             "source": "redtail_tpu_torch/csrc/fused_cv_emit.cu",
             "replaces": "redtail_tpu/kernels/fused_cv_emit_pallas.py:65",
             "launches": None, "max_abs_err": max_err}
    maps = (la.numel() + rb.numel()) * 2 + k * 4
    full = n * d * h * w * k
    packed = n * ((d + 1) // 2 + 1) * ((h + 1) // 2 + 1) * w * 4 * k
    # per output: the S add, the bias add and the ELU (exp, select)
    entry.update(time_kernel(
        torch, f"emit full at {(n, h, w, k)} D={d} bf16",
        lambda: emit.fused_cv_emit(la, rb, bias, d),
        lambda: emit.fused_cv_emit_plain(la, rb, bias, d),
        maps + full * 2, 4 * full))
    timed = time_kernel(
        torch, f"emit dh_shifted at {(n, h, w, k)} D={d} bf16",
        lambda: emit.fused_cv_emit(la, rb, bias, d, layout="dh_shifted"),
        lambda: emit.fused_cv_emit_plain(la, rb, bias, d,
                                         layout="dh_shifted"),
        maps + packed * 2, 4 * full)
    entry.update({f"packed_{key}": timed[key] for key in
                  ("ms", "plain_ms", "bound_ms", "bound_by", "bound_share")})
    # Both layouts once more without the ELU, a call no model makes: the
    # difference is what the fp32 expm1f of every output costs.
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for prefix, layout in (("", "full"), ("packed_", "dh_shifted")):
        entry[f"{prefix}no_elu_ms"] = cuda_ms(
            torch, lambda: emit.fused_cv_emit(la, rb, bias, d, elu=False,
                                              layout=layout), flush)
    print(f"emit at {(n, h, w, k)} D={d} bf16 without the ELU, device time: "
          f"full {entry['no_elu_ms']:.4f} ms, dh_shifted "
          f"{entry['packed_no_elu_ms']:.4f} ms")
    return entry


def _conv223_inputs(torch, gen, xshape, k_out, dtype):
    """xp, k in the (2, 2, 3, C, K) form, bias."""
    c = xshape[-1]
    xp = _randn(torch, gen, xshape, dtype)
    # He-scaled weights: O(1) outputs, as the head's are
    k = (torch.randn((2, 2, 3, c, k_out), generator=gen, device="cuda")
         * (12 * c) ** -0.5).to(dtype)
    return xp, k, _randn(torch, gen, (k_out,), torch.float32)


def _conv223_library(torch, xp, k, bias):
    """cuDNN's `F.conv3d` of the same dense (2, 2, 3) conv, W padded
    (1, 1), bias in the call, in xp's dtype: the library yardstick."""
    x = xp.permute(0, 4, 1, 2, 3)            # channels_last_3d view
    wt = k.permute(4, 3, 0, 1, 2).contiguous(
        memory_format=torch.channels_last_3d)
    b = bias.to(xp.dtype)
    return lambda: torch.nn.functional.conv3d(x, wt, b, padding=(0, 0, 1))


def phase_conv223(torch, c223, gen):
    """The packed head's dense conv kernel against its plain version, then
    timed at NVSmall's conv3D_2 call beside its plain version and cuDNN,
    and at ResNet-18 3D's conv3D_1b beside cuDNN. The timed calls take the
    weights as the packed head holds them, in the bf16 kernel's K-major
    form (`kernel_weights`, made at load)."""
    max_err = 0.0
    for name, xshape, k_out in CONV223_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            xp, k, bias = _conv223_inputs(torch, gen, xshape, k_out, dtype)
            got = c223.conv223(xp, k, bias)
            torch.cuda.synchronize()
            want = c223.conv223_plain(xp, k, bias)
            check(got.shape == want.shape and got.dtype == want.dtype,
                  f"conv223 {name}: {got.shape} {got.dtype} vs "
                  f"{want.shape} {want.dtype}")
            err = (got.float() - want.float()).abs().max().item()
            if dtype == torch.float32:
                check(err <= FP32_ATOL, f"conv223 {name} fp32: max abs err "
                      f"{err} > {FP32_ATOL}")
                max_err = max(max_err, err)
                tol = f"{FP32_ATOL}"
            else:
                check(bf16_ulp_ok(torch, got, want, FP32_ATOL),
                      f"conv223 {name} bf16: more than one bf16 ulp + "
                      f"{FP32_ATOL} off (max abs err {err})")
                tol = f"1 bf16 ulp + {FP32_ATOL}"
            print(f"conv223 {name:10s} {str(xshape):22s} K={k_out:<3d} "
                  f"{str(dtype):15s} max_abs_err={err:.3e} (tol {tol})")
            del got, want, xp, k

    entry = {"name": "conv223", "route": "cuda",
             "source": "redtail_tpu_torch/csrc/conv223.cu",
             "replaces": "redtail_tpu/kernels/conv223_pallas.py:60",
             "launches": None, "max_abs_err": max_err}
    for name, xshape, k_out in CONV223_CASES[:2]:
        xp, k, bias = _conv223_inputs(torch, gen, xshape, k_out,
                                      torch.bfloat16)
        n, dp, hp, w, c = xshape
        out = n * (dp - 1) * (hp - 1) * w * k_out
        library = _conv223_library(torch, xp, k, bias)
        kt = c223.kernel_weights(k)
        got, want = c223.conv223(xp, kt, bias, "kc"), library()
        lib_err = (got.float() - want.permute(0, 2, 3, 4, 1).float()
                   ).abs().max().item()
        print(f"conv223 {name} bf16 vs cuDNN F.conv3d of the same conv: max "
              f"abs err {lib_err:.3e} (informational: cuDNN rounds in its "
              f"own order)")
        del got, want
        timed = time_kernel(
            torch, f"conv223 {name} at {xshape} K={k_out} bf16",
            lambda: c223.conv223(xp, kt, bias, "kc"),
            lambda: c223.conv223_plain(xp, k, bias),
            2 * (xp.numel() + k.numel() + out) + 4 * k_out,
            2 * out * 12 * c, library=library, peak_flops=PEAK_BF16_FLOPS)
        if name == "nvsmall":
            entry.update(timed)
        else:
            entry.update({f"{name}_{key}": timed[key] for key in
                          ("ms", "plain_ms", "library_ms", "bound_ms",
                           "bound_share")})
        del xp, k, kt, library
    return entry


def phase_slice(np, torch, models, s2d, lowerings):
    """The models on the card against the same models on the CPU, under
    each lowering (``lowerings``: name -> context manager). Under the
    packed lowering the card takes the D-folded final deconv and the CPU
    the unpack branch, so the two final-deconv forms meet here."""
    cases = [("resnet18_2d", (129, 257), 16, "fused", 1e-3, 1e-2, "")]
    cases += [(name, SLICE_3D_HW, SLICE_3D_DISP, lowering,
               SLICE_3D_FP32_ATOL, SLICE_3D_BF16_MEAN, " px")
              for name in ("nvtiny", "nvsmall", "resnet18")
              for lowering in ("fused", "plain", "packed")]
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
        with torch.inference_mode(), lowerings[lowering]():
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


def read_counts(counters):
    """Each kernel wrapper's launch count (the emission's packed ones too)."""
    counts = {c.__name__: c.launches for c in counters}
    counts.update({f"{c.__name__}.packed": c.packed_launches
                   for c in counters if hasattr(c, "packed_launches")})
    return counts


def zero_counts(counters):
    for c in counters:
        c.launches = 0
        if hasattr(c, "packed_launches"):
            c.packed_launches = 0


def serve(np, torch, node, frames, counters, max_disp_px, label):
    """The main path: every launch count set to 0, ``frames`` served, the
    counts read. Returns (disparities, counts, median latency ms)."""
    for _ in range(2):  # warm-up: cuDNN algorithm choice, kernel load
        node(*frames[0])
    node.profiler.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(counters)
    lat, outs = [], []
    for left, right in frames:
        t0 = time.perf_counter()
        disp = node(left, right)  # ends in a copy to the host
        lat.append(1e3 * (time.perf_counter() - t0))
        outs.append(disp)
    counts = read_counts(counters)
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
    check(counts["corr_softargmax"] == SERVE_FRAMES,
          f"the corr kernel's fused soft-argmax launched "
          f"{counts['corr_softargmax']} times for {SERVE_FRAMES} frames")
    check(counts["corr_cost_volume"] == 0,
          f"the fused path launched the corr volume "
          f"{counts['corr_cost_volume']} times")
    trace_frames(torch, node, frames[:3], med, match="corr_kernel")
    return counts["corr_softargmax"], counts["corr_cost_volume"]


def phase_serve_3d(np, torch, models, nodes, counters, plain_lowering,
                   packed3d_lowering):
    """StereoNode NVSmall at the full width, bf16, the repo's real weights;
    then one frame under `plain_lowering()`, then the same frames under
    `packed3d_lowering()`. Returns each kernel's launches per path."""
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
    layer_breakdown(torch, node, frames[0], "nvsmall fused")

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

    with packed3d_lowering():
        packed_out, packed_counts, packed_med = serve(
            np, torch, node, frames, counters, spec.full_max_disp,
            f"{label} under packed3d_lowering()")
        print_clocks("serving nvsmall packed")
        print(node.profiler.report())
        for kernel in ("conv223", "fused_cv_emit", "fused_cv_emit.packed"):
            check(packed_counts[kernel] == SERVE_FRAMES,
                  f"the packed head launched {kernel} "
                  f"{packed_counts[kernel]} times for {SERVE_FRAMES} frames")
        check(packed_counts["cost_volume_concat"] == 0,
              "the packed head launched the concat kernel")
        trace_frames(torch, node, frames[:3], packed_med)
        layer_breakdown(torch, node, frames[0], "nvsmall packed")
    diff = np.abs(np.stack(packed_out) - np.stack(fused_out))
    print(f"nvsmall packed vs fused head, the same {SERVE_FRAMES} frames, "
          f"bf16: mean abs diff {diff.mean():.4e} px (gate {PACKED_MEAN}), "
          f"max {diff.max():.4e} px (gate {PACKED_MAX}); per frame mean "
          f"{[round(float(d.mean()), 5) for d in diff]}, max "
          f"{[round(float(d.max()), 3) for d in diff]}")
    check(diff.mean() < PACKED_MEAN and diff.max() < PACKED_MAX,
          "the packed and fused heads disagree past the gate")
    return {"fused_cv_emit": {"5b nvsmall fused": counts["fused_cv_emit"],
                              "5d nvsmall packed":
                                  packed_counts["fused_cv_emit.packed"]},
            "cost_volume_concat": {"5c nvsmall plain":
                                   plain_counts["cost_volume_concat"]},
            "conv223": {"5d nvsmall packed": packed_counts["conv223"]}}


def layer_breakdown(torch, node, frame, label):
    """Informational: device time of each conv layer of one served frame
    (CUDA events around each layer's forward: its TF-SAME pad, the cuDNN
    call or the conv223 kernel, the fp32 bias add and, in the packed head,
    the boundary-slot masks; not the ELU after it; the packed head's
    D-folded deconv3D_3 includes its fused soft-argmin); "rest" is the
    rest of the frame's span: the cost volume and conv3D_1 assembly, ELU,
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
        # leaf layers: the spec's convs, and the packed head's layers,
        # which hold only buffers
        if not list(mod.children()) and (
                list(mod.parameters(recurse=False))
                or list(mod.buffers(recurse=False))):
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
    print(f"per-layer device time, one {label} frame ({total:.3f} ms from "
          f"the first upload to the last copy):")
    for name, ms in rows:
        print(f"  {name:32s} {ms:8.3f} ms")
    print(f"  {'rest':32s} {total - sum(ms for _, ms in rows):8.3f} ms "
          f"(other device work, and the device idle while the host packs)")


def trace_frames(torch, node, frames, frame_ms, match=None, table=True):
    """Informational: device time by kernel over a few served frames
    (`torch.profiler`; ``frames`` holds each call's arguments), and the
    device's idle share of the unprofiled per-frame latency ``frame_ms``;
    each kernel whose name holds ``match`` also on a line of its own; the
    table of the busiest kernels unless ``table`` is false. Returns (device busy ms, device operations) per frame, or None where
    the profiler recorded no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for args in frames:
            node(*args)
    events = prof.key_averages()
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not e.is_user_annotation]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3 / len(
        frames)
    if busy_ms == 0:
        print("trace: the profiler recorded no device time")
        return None
    copies = sum(e.count for e in device
                 if e.key.startswith(("Memcpy", "Memset"))) / len(frames)
    ops = sum(e.count for e in device) / len(frames)
    print(f"trace over {len(frames)} frames: device busy {busy_ms:.3f} ms "
          f"per frame; idle share {1 - busy_ms / frame_ms:.3f} of the "
          f"{frame_ms:.3f} ms median latency; {ops:g} device operations per "
          f"frame, {ops - copies:g} kernel launches and {copies:g} copies or "
          f"memsets")
    if table:
        print(events.table(sort_by="self_cuda_time_total", row_limit=15,
                           max_name_column_width=60))
    for e in events:
        if match and match in e.key and e.device_type == DeviceType.CUDA:
            print(f"trace: {e.key[:90]}: {e.count / len(frames):g} calls "
                  f"and {e.self_device_time_total / 1e3 / len(frames):.4f} "
                  f"ms of device time per frame")
    return busy_ms, ops - copies


def print_counts(counters, when):
    for name, count in read_counts(counters).items():
        print(f"kernel counter {name} {when}: {count}")


def phase_trailnet(np, torch, io, models, trailnet, nodes):
    """TrailNet at 180x320, both forms, card against CPU; then
    `TrailNetNode` serving, both forms, fp32 and bf16. Returns the serving
    figures by (form, dtype)."""
    tree = trailnet.params_from_w8_npz(ROOT / TRAILNET_W8)
    proto = io.parse_prototxt(models.emit_trailnet_prototxt())
    blobs = models.native_params_to_blobs(tree)

    def make(form, dtype, device=None):
        if form == "caffe":
            return models.CaffeNet(proto, blobs, dtype=dtype, device=device)
        return trailnet.params_from_numpy(tree, device=device, dtype=dtype)

    x = torch.from_numpy(np.random.default_rng(6).integers(
        0, 256, (2, 180, 320, 3), dtype=np.uint8))
    for form in ("caffe", "native"):
        with torch.inference_mode():
            ref = make(form, torch.float32, "cpu")(x).numpy()
            check(ref.shape == (2, 6) and np.isfinite(ref).all()
                  and np.allclose(ref.reshape(2, 2, 3).sum(-1), 1, atol=1e-5),
                  f"trailnet {form}: CPU probabilities {ref}")
            for dtype in (torch.float32, torch.bfloat16):
                got = make(form, dtype)(x.cuda()).float().cpu().numpy()
                err = np.abs(got - ref)
                print(f"trailnet {form} 180x320 {dtype}: card vs CPU fp32 "
                      f"max abs err {err.max():.3e}, mean {err.mean():.3e} "
                      f"(gate: fp32 max {TRAILNET_FP32_ATOL}, bf16 mean "
                      f"{TRAILNET_BF16_MEAN}); card {got[0].round(5)}")
                if dtype == torch.float32:
                    check(err.max() <= TRAILNET_FP32_ATOL,
                          f"trailnet {form} fp32: card off CPU by {err.max()}")
                else:
                    check(err.mean() <= TRAILNET_BF16_MEAN,
                          f"trailnet {form} bf16: card off CPU by mean "
                          f"{err.mean()}")

    frames = np.random.default_rng(7).integers(
        0, 256, (TRAILNET_FRAMES + 5, 180, 320, 3), dtype=np.uint8)
    figures = {}
    for form in ("caffe", "native"):
        for dtype in (torch.float32, torch.bfloat16):
            label = f"trailnet {form} 180x320 {dtype}"
            node = nodes.TrailNetNode(make(form, dtype))
            for frame in frames[:2]:  # warm-up: cuDNN algorithm choice
                node(frame)
            node.profiler.reset()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            lat = []
            for frame in frames[2:2 + TRAILNET_FRAMES]:
                t0 = time.perf_counter()
                probs = node(frame)  # ends in a copy to the host
                lat.append(1e3 * (time.perf_counter() - t0))
                check(probs.shape == (6,) and np.isfinite(probs).all()
                      and np.allclose(probs.reshape(2, 3).sum(-1), 1,
                                      atol=2e-2),
                      f"{label}: served {probs}")
            peak = torch.cuda.max_memory_allocated() / 2**20
            med, mean = statistics.median(lat), statistics.fmean(lat)
            print(f"serve {label}: {TRAILNET_FRAMES} frames, per-frame "
                  f"latency median {med:.3f} ms, mean {mean:.3f} ms (min "
                  f"{min(lat):.3f}, max {max(lat):.3f}; host clock, "
                  f"synchronized); peak device memory {peak:.1f} MiB")
            print(node.profiler.report())
            traced = trace_frames(torch, node, [(f,) for f in frames[-3:]],
                                  med)
            check(traced is not None, f"{label}: no device time traced")
            busy, launches = traced
            figures[f"{form} {str(dtype).split('.')[-1]}"] = {
                "median_ms": med, "mean_ms": mean, "busy_ms": busy,
                "idle_share": 1 - busy / med, "launches": launches,
                "peak_mib": peak}
    print_clocks("serving trailnet")
    print(json.dumps({"trailnet_serving": figures}))
    return figures


def yolo_standin_prototxt(widths) -> str:
    """A YOLO-shaped graph, not the YOLO model: a 448x448 BGR frame, /255
    in a Scale layer, four Convolution / leaky-ReLU / Pooling stages down
    to 7x7, Dropout, and an InnerProduct to the (1470,) YOLOv1 head."""
    c1, c2, c3, c4 = widths
    conv = ('layer {{ name: "{0}" type: "Convolution" bottom: "{1}" top: '
            '"{0}" convolution_param {{ num_output: {2} kernel_size: {3} '
            'stride: {4} pad: {5} }} }}\n'
            'layer {{ name: "relu_{0}" type: "ReLU" bottom: "{0}" top: "{0}" '
            'relu_param {{ negative_slope: 0.1 }} }}\n')
    pool = ('layer {{ name: "{0}" type: "Pooling" bottom: "{1}" top: "{0}" '
            'pooling_param {{ pool: {2} kernel_size: 2 stride: 2 }} }}\n')
    return ('input: "data"\ninput_shape { dim: 1 dim: 3 dim: 448 dim: 448 }\n'
            'layer { name: "scale" type: "Scale" bottom: "data" top: '
            '"scaled" scale_param { filler { value: 0.00392156862745098 } } }\n'
            + conv.format("conv1", "scaled", c1, 7, 2, 3)
            + pool.format("pool1", "conv1", "MAX")
            + conv.format("conv2", "pool1", c2, 3, 1, 1)
            + pool.format("pool2", "conv2", "MAX")
            + conv.format("conv3", "pool2", c3, 3, 2, 1)
            + pool.format("pool3", "conv3", "MAX")
            + conv.format("conv4", "pool3", c4, 1, 1, 0)
            + pool.format("pool4", "conv4", "AVE")
            + 'layer { name: "drop" type: "Dropout" bottom: "pool4" top: '
            '"pool4" }\n'
            'layer { name: "fc" type: "InnerProduct" bottom: "pool4" top: '
            '"result" inner_product_param { num_output: 1470 } }\n')


def phase_yolo(np, torch, io, models, nodes):
    """`YoloNode` on the stand-in graph: the card's raw head against the
    CPU's on one seeded 448x448 frame, then the detections' contract."""
    proto = io.parse_prototxt(yolo_standin_prototxt(YOLO_STANDIN_WIDTHS))
    card = models.CaffeNet(proto, seed=0)
    cpu = models.CaffeNet(proto, seed=0, device="cpu")
    frame = np.random.default_rng(8).integers(0, 256, (448, 448, 3),
                                              dtype=np.uint8)
    with torch.inference_mode():
        want = cpu(frame).numpy()[0]
        got = card(frame).float().cpu().numpy()[0]
    scale = max(1.0, float(np.abs(want).max()))
    err = np.abs(got - want).max()
    print(f"yolo stand-in (not the YOLO model) 448x448 -> 1470, random "
          f"weights: card vs CPU fp32 raw head max abs err {err:.3e} (gate "
          f"{FP32_ATOL} x {scale:.3f}, the head's largest magnitude)")
    check(want.shape == (1470,) and np.isfinite(got).all()
          and err <= FP32_ATOL * scale, f"yolo stand-in: card off CPU by {err}")
    node = nodes.YoloNode(card)
    det = node(frame)
    check(det.dtype == np.float32 and det.ndim == 2 and det.shape[1] == 6,
          f"yolo stand-in: detections {det.dtype} {det.shape}")
    labels, probs, boxes = det[:, 0], det[:, 1], det[:, 2:]
    check((labels == np.round(labels)).all() and (labels >= 0).all()
          and (labels < 20).all() and (probs >= node.prob_threshold).all()
          and (boxes == np.round(boxes)).all() and (boxes[:, 2:] >= 1).all()
          and (boxes[:, 0] + boxes[:, 2] <= 448).all()
          and (boxes[:, 1] + boxes[:, 3] <= 448).all(),
          f"yolo stand-in: detections break the (n, 6) contract: {det}")
    print(f"yolo stand-in: YoloNode gave {len(det)} detection(s) of the "
          f"(n, 6) [label, prob, x, y, w, h] contract (CPU node: "
          f"{len(nodes.YoloNode(cpu, device='cpu')(frame))}); stages "
          f"{sorted(node.profiler.stats())}")


def host_ms(fn, reps=20):
    """Median host time of ``fn()`` in ms, after 3 warm-up calls."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def phase_native(np, native, s2d):
    """7a: the native host runtime built from the checkout, and its pack
    bit-equal to numpy's on a full-width frame."""
    built = native.library_path().exists()
    t0 = time.perf_counter()
    path = native.build()
    check(native.load() is not None, f"the native runtime {path} does not "
          f"load")
    print(f"native runtime: {path.relative_to(ROOT)}, " + (
        "built from the checkout at its first use by the nodes of the "
        "earlier phases" if built else
        f"built from the checkout in {time.perf_counter() - t0:.2f} s"))
    frame = np.random.default_rng(9).integers(0, 256, FULL_HW + (3,),
                                              dtype=np.uint8)
    before = (native.pack_s2d.native_calls, native.pack_s2d.numpy_calls)
    got = native.pack_s2d(frame, swap_rb=True)
    want = s2d(frame[..., ::-1])
    check((native.pack_s2d.native_calls, native.pack_s2d.numpy_calls)
          == (before[0] + 1, before[1]), "pack_s2d did not take the native "
          "path")
    check(got.dtype == np.uint8 and got.shape == want.shape
          and np.array_equal(got, want),
          "the native s2d pack differs from space_to_depth2_np")
    native_ms = host_ms(lambda: native.pack_s2d(frame, swap_rb=True))
    numpy_ms = host_ms(lambda: s2d(frame[..., ::-1]))
    print(f"native s2d pack of one {FULL_HW[0]}x{FULL_HW[1]}x3 frame: "
          f"bit-equal to space_to_depth2_np; host median {native_ms:.3f} ms "
          f"native, {numpy_ms:.3f} ms numpy")
    return {"native_ms": native_ms, "numpy_ms": numpy_ms}


def drive(node, frames):
    """Serve ``frames`` through a node, then as many repeats of the first
    frame as it takes to bring back the last result. Returns (results as
    (data, stamp), stamp-to-result latencies in ms, the call stamps, calls
    made, frames/s). The rate is taken from the first result to the last
    (results - 1 frame periods), so it is the steady state's: the priming
    calls of an overlapped node, and the repeats, fall outside it."""
    want = len(frames)
    calls = list(frames) + [frames[0]] * (node.microbatch
                                          * (node.overlap + 1))
    results, lat, sent, arrivals = [], [], [], []
    for n, (left, right) in enumerate(calls, 1):
        stamp = time.monotonic()
        sent.append(stamp)
        out = node(left, right, stamp=stamp)
        now = time.monotonic()
        if not node.overlap:
            out = [(out, stamp)]
        elif out is None:
            out = []
        else:
            out = [(o.data, o.stamp)
                   for o in (out if isinstance(out, list) else [out])]
        for data, at in out:
            results.append((data, at))
            lat.append(1e3 * (now - at))
            arrivals.append(now)
        if len(results) >= want:
            break
    node.drain()
    fps = (want - 1) / (arrivals[want - 1] - arrivals[0])
    return results[:want], lat[:want], sent, n, fps


def overlap_setup(np, models):
    """7b's model and frames: ResNet18-2D at full width, random weights
    from seed 0, 20 seeded frame pairs."""
    spec = dataclasses.replace(models.STEREO_SPECS["resnet18_2d"],
                               input_hw=FULL_HW)
    return (spec, models.init_stereo_params(spec, seed=0),
            stereo_frames(np, 2, OVERLAP_FRAMES))


def overlap_child(np, torch, models, nodes, counters):
    """7b, run in a process of its own (`OVERLAP_CHILD`): the host's
    enqueue slows down for the rest of a process once `torch.profiler`
    has traced in it, so the serving modes are timed here, where nothing
    has. Each mode is driven twice, in turns (0, 1, 2, then 2, 1, 0), its
    counts zeroed just before and read just after, then traced for its
    device time; prints one JSON line last."""
    spec, params, frames = overlap_setup(np, models)
    modes = {overlap: nodes.StereoNode(spec, params, dtype=torch.bfloat16,
                                       overlap=overlap)
             for overlap in OVERLAP_MODES}
    for node in modes.values():
        node.warmup(*frames[0])
    ref = [d for d, _ in drive(modes[0], frames)[0]]
    again = [d for d, _ in drive(modes[0], frames)[0]]
    repeat = all(np.array_equal(a, d) for a, d in zip(again, ref))
    print(f"resnet18_2d {FULL_HW[0]}x{FULL_HW[1]} bf16 synchronous: a second "
          f"pass of the same frames bit-equal to the first: {repeat}")
    check(repeat, "the synchronous node does not repeat itself bit for bit: "
          "overlap cannot be held to bit-equality")
    runs = {overlap: [] for overlap in OVERLAP_MODES}
    launches = {}
    for order in (OVERLAP_MODES, OVERLAP_MODES[::-1]):
        for overlap in order:
            node = modes[overlap]
            label = (f"resnet18_2d {FULL_HW[0]}x{FULL_HW[1]} bf16 overlap "
                     f"{overlap}")
            node.profiler.reset()
            torch.cuda.synchronize()
            zero_counts(counters)
            results, lat, sent, calls, fps = drive(node, frames)
            counts = read_counts(counters)
            check(counts["corr_softargmax"] == calls,
                  f"{label}: the fused corr kernel launched "
                  f"{counts['corr_softargmax']} times for {calls} calls")
            check([at for _, at in results] == sent[:len(frames)],
                  f"{label}: results out of order or under other stamps")
            bad = [i for i, ((d, _), r) in enumerate(zip(results, ref))
                   if not (d.shape == FULL_HW and np.array_equal(d, r))]
            check(not bad, f"{label}: frames {bad} differ from the "
                  f"synchronous node's")
            runs[overlap].append((fps, statistics.median(lat), max(lat)))
            launches[overlap] = counts["corr_softargmax"]
            print(f"serve {label}, pass {len(runs[overlap])}: "
                  f"{len(frames)} frames, {fps:.2f} frames/s from the first "
                  f"result to the last (host clock); "
                  f"stamp-to-result latency median {runs[overlap][-1][1]:.3f}"
                  f" ms, max {max(lat):.3f} ms; bit-equal to the synchronous "
                  f"node's; launches {counts}")
            print(node.profiler.report())
    figures = {}
    for overlap, node in modes.items():  # traced last: see the docstring
        fps = statistics.fmean(r[0] for r in runs[overlap])
        traced = trace_frames(torch, node, frames[:6], 1e3 / fps)
        node.drain()
        check(traced is not None, f"overlap {overlap}: no device time traced")
        busy, ops = traced
        figures[f"overlap {overlap}"] = {
            "frames_per_s": [r[0] for r in runs[overlap]],
            "latency_median_ms": [r[1] for r in runs[overlap]],
            "latency_max_ms": [r[2] for r in runs[overlap]],
            "busy_ms": busy, "idle_share": 1 - busy * fps / 1e3,
            "launches": ops}
    print_clocks("the overlap phase")
    print(json.dumps({"overlap_serving": figures,
                      "corr_launches": launches}))


def phase_overlap(np, torch, models, nodes):
    """7b: ResNet18-2D at full width through `StereoNode` with 0, 1 and 2
    frames in flight, in a fresh process (`overlap_child`). Returns
    (frames, this process's synchronous disparities for 7c-7d, the
    weights, the corr kernel's launches by path)."""
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                           OVERLAP_CHILD], capture_output=True, text=True,
                          timeout=600, cwd=ROOT)
    print(proc.stdout.rstrip())
    check(proc.returncode == 0, f"the 7b process exited {proc.returncode}: "
          f"{proc.stderr[-3000:]}")
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    by_path = {f"7b resnet18_2d overlap {overlap}": n
               for overlap, n in result["corr_launches"].items()}
    spec, params, frames = overlap_setup(np, models)
    node = nodes.StereoNode(spec, params, dtype=torch.bfloat16)
    ref = [node(*f) for f in frames]
    return frames, ref, params, by_path


def mb_serve(np, torch, node, frames, counters, label):
    """Frames through an overlapped, microbatched node, the counts zeroed
    just before and read just after; returns (disparities in frame order,
    counts, dispatches)."""
    node.warmup(*frames[0])
    torch.cuda.synchronize()
    zero_counts(counters)
    results, _, sent, calls, _ = drive(node, frames)
    counts = read_counts(counters)
    check([at for _, at in results] == sent[:len(frames)],
          f"{label}: results out of order or under other stamps")
    check(calls % node.microbatch == 0, f"{label}: {calls} calls")
    return [d for d, _ in results], counts, calls // node.microbatch


def phase_microbatch(np, torch, models, nodes, counters, packed3d_lowering,
                     frames2d, ref2d, params2d):
    """7c: overlap 1, microbatch 2: ResNet18-2D at full width and NVTiny at
    65x129 under the fused and the packed head, each within the bf16 gates
    of the synchronous node, its kernels launched once per batch of two.
    Returns the launches by kernel and path."""
    spec = dataclasses.replace(models.STEREO_SPECS["resnet18_2d"],
                               input_hw=FULL_HW)
    label = (f"resnet18_2d {FULL_HW[0]}x{FULL_HW[1]} bf16 overlap 1 "
             "microbatch 2")
    node = nodes.StereoNode(spec, params2d, dtype=torch.bfloat16, overlap=1,
                            microbatch=2)
    disps, counts, batches = mb_serve(np, torch, node, frames2d, counters,
                                      label)
    check(counts["corr_softargmax"] == batches,
          f"{label}: the corr kernel launched {counts['corr_softargmax']} "
          f"times for {batches} batches")
    want = np.stack(ref2d)
    err = np.abs(np.stack(disps) - want) / FULL_HW[1]
    free = want < FULL_HW[1] * (1.0 - 2.0 ** -9)  # bf16 sigmoid below 1
    print(f"{label}: {counts['corr_softargmax']} corr launches for "
          f"{len(frames2d)} frames; against the synchronous node, sigmoid "
          f"units: mean {err[free].mean():.3e} over the {free.mean():.4f} "
          f"share of pixels whose sigmoid is below 1 (gate {MB_2D_MEAN}, "
          f"share >= {MB_2D_FREE_SHARE}), mean {err.mean():.3e} over all, "
          f"max {err.max():.3e}")
    check(free.mean() >= MB_2D_FREE_SHARE,
          f"{label}: only {free.mean()} of the pixels below the sigmoid's "
          f"saturation")
    check(err[free].mean() < MB_2D_MEAN, f"{label}: off the synchronous "
          f"node by mean {err[free].mean()} below the saturation")
    by_path = {"corr_cost_volume": {"7c resnet18_2d microbatch 2":
                                    counts["corr_softargmax"]},
               "fused_cv_emit": {}, "conv223": {}}

    spec = dataclasses.replace(models.STEREO_SPECS["nvtiny"],
                               input_hw=SLICE_3D_HW, max_disp=SLICE_3D_DISP)
    tree = conditioned_params(np, models.init_stereo_params(spec, seed=1), 2)
    rng = np.random.default_rng(10)
    frames = []
    for _ in range(MB_3D_FRAMES):
        left = rng.integers(0, 256, SLICE_3D_HW + (3,), dtype=np.uint8)
        frames.append((left, np.roll(left, -3, axis=1)))
    for name, lowering, kernels in (
            ("fused", contextlib.nullcontext, ("fused_cv_emit",)),
            ("packed", packed3d_lowering,
             ("conv223", "fused_cv_emit.packed"))):
        label = f"nvtiny 65x129 bf16 {name} head overlap 1 microbatch 2"
        sync = nodes.StereoNode(spec, tree, dtype=torch.bfloat16)
        node = nodes.StereoNode(spec, tree, dtype=torch.bfloat16, overlap=1,
                                microbatch=2)
        with lowering():
            sync(*frames[0])
            zero_counts(counters)
            want = [sync(*f) for f in frames]
            per_frame = {k: read_counts(counters)[k] // len(frames)
                         for k in kernels}
            disps, counts, batches = mb_serve(np, torch, node, frames,
                                              counters, label)
        for k in kernels:
            check(per_frame[k] >= 1 and counts[k] == per_frame[k] * batches,
                  f"{label}: {k} launched {counts[k]} times for {batches} "
                  f"batches ({per_frame[k]} a synchronous frame)")
        diff = np.abs(np.stack(disps) - np.stack(want))
        print(f"{label}: launches {({k: counts[k] for k in kernels})} for "
              f"{batches} batches of 2 ({per_frame} a synchronous frame); "
              f"against the synchronous node: mean {diff.mean():.3e} px "
              f"(gate {SLICE_3D_BF16_MEAN}), max {diff.max():.3e} px")
        check(diff.mean() < SLICE_3D_BF16_MEAN,
              f"{label}: off the synchronous node by mean {diff.mean()}")
        path = f"7c nvtiny {name} microbatch 2"
        by_path["fused_cv_emit"][path] = counts[kernels[-1]]
        if name == "packed":
            by_path["conv223"][path] = counts["conv223"]
    return by_path


def phase_u16(np, torch, models, nodes, counters, frames, ref, params):
    """7d: the u16 wire against the f32 wire on 7b's frames."""
    spec = dataclasses.replace(models.STEREO_SPECS["resnet18_2d"],
                               input_hw=FULL_HW)
    node = nodes.StereoNode(spec, params, dtype=torch.bfloat16, wire="u16")
    node.warmup(*frames[0])
    torch.cuda.synchronize()
    zero_counts(counters)
    got = np.stack([node(*f) for f in frames])
    counts = read_counts(counters)
    want = np.stack(ref)
    below = want < U16_MAX_PX - U16_ATOL
    err = np.abs(got - want)[below]
    clipped = int((~below).sum())
    print(f"u16 wire vs f32 wire, resnet18_2d 321x1025 bf16, {len(frames)} "
          f"frames: max abs diff {err.max():.6f} px below "
          f"{U16_MAX_PX - U16_ATOL} px (tol {U16_ATOL}); {clipped} of "
          f"{want.size} pixels at or above it, served as "
          f"{np.unique(got[~below]).tolist()[:4]} px (max f32 "
          f"{want.max():.3f} px)")
    check(got.dtype == np.float32 and err.max() <= U16_ATOL + 1e-6,
          f"u16 wire off the f32 wire by {err.max()} px")
    check(((got[~below] >= U16_MAX_PX - U16_ATOL)
           & (got[~below] <= U16_MAX_PX)).all(),
          "the u16 wire did not saturate at 65535 / 64 px")
    check(counts["corr_softargmax"] == len(frames),
          f"u16 wire: {counts['corr_softargmax']} corr launches")
    return {"7d resnet18_2d u16 wire": counts["corr_softargmax"]}


def phase_pipeline(np, models, native, counters):
    """7e: `pipeline_app.main` in this process."""
    from redtail_tpu_torch.apps import pipeline_app

    check(importlib.util.find_spec("cv2") is not None,
          "pipeline_app needs cv2: TrailNet and YOLO resize the 321x1025 "
          "camera frames on the host with it, as in the JAX package")
    work = ROOT / "redtail_tpu_torch" / "build" / "smoke"
    work.mkdir(parents=True, exist_ok=True)
    trailnet_proto = work / "trailnet.prototxt"
    yolo_proto = work / "yolo_standin.prototxt"
    trailnet_proto.write_text(models.emit_trailnet_prototxt())
    yolo_proto.write_text(yolo_standin_prototxt(YOLO_STANDIN_WIDTHS))
    argv = ["--duration", str(PIPELINE_SECONDS), "--trailnet-prototxt",
            str(trailnet_proto), "--yolo-prototxt", str(yolo_proto),
            "--fcu", "mavlink", "--demo-person-stop", str(PERSON_STOP_S)]
    zero_counts(counters)
    packs = (native.pack_s2d.native_calls, native.pack_s2d.numpy_calls)
    out, err = stdio.StringIO(), stdio.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        pipeline_app.main(argv)
    wall = time.perf_counter() - t0
    counts = read_counts(counters)
    packs = (native.pack_s2d.native_calls - packs[0],
             native.pack_s2d.numpy_calls - packs[1])
    print(f"pipeline_app {' '.join(argv[:2])} ... ({wall:.1f} s with the "
          f"warm-up); its stderr, the profiler report:")
    print(err.getvalue().rstrip())
    line = out.getvalue().strip().splitlines()[-1]
    print(f"pipeline_app summary: {line}")
    s = json.loads(line)
    frames = s["frames"]
    print(f"pipeline_app: launches {counts}; native packs {packs[0]}, numpy "
          f"packs {packs[1]}; stereo {frames['stereo'] / PIPELINE_SECONDS:.2f}"
          f" frames/s, trailnet {frames['trailnet'] / PIPELINE_SECONDS:.2f}, "
          f"controller {frames['controller'] / PIPELINE_SECONDS:.2f} (over "
          f"the {PIPELINE_SECONDS} s run)")
    for name in ("stereo", "trailnet", "controller"):
        check(frames.get(name, 0) > 0, f"pipeline_app: no {name} frames: {s}")
    check(not any(s["errors"].values()), f"pipeline_app errors: {s}")
    check(s["stop_events"] >= 1, f"pipeline_app: no person-stop: {s}")
    check(s["mavlink"]["armed"] and s["mavlink"]["bad_crc"] == 0,
          f"pipeline_app: MAVLink FCU not armed or bad CRCs: {s}")
    check(counts["corr_softargmax"] >= frames["stereo"],
          f"pipeline_app: {counts['corr_softargmax']} corr launches for "
          f"{frames['stereo']} stereo frames")
    check(packs[1] == 0 and packs[0] >= 2 * frames["stereo"],
          f"pipeline_app: {packs[0]} native and {packs[1]} numpy packs for "
          f"{frames['stereo']} stereo frames")
    return {"7e pipeline_app": counts["corr_softargmax"]}, s


def phase_sim(counters):
    """7f: the closed-loop simulation with TrailNet on the card."""
    from redtail_tpu_torch.apps import sim_app

    before = read_counts(counters)
    out = stdio.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = sim_app.main(["--real-dnn"])
    line = out.getvalue().strip().splitlines()[-1]
    print(f"sim_app --real-dnn ({time.perf_counter() - t0:.1f} s): exit {rc}"
          f": {line}")
    check(rc == 0, f"sim_app --real-dnn exited {rc}: {line}")
    check(read_counts(counters) == before,
          "a kernel launched on the TrailNet simulation path")

# ------------------------------------------------------------------ phase 8


def phase_blob(np, torch, io, models, nodes, frame, card="cuda"):
    """8a: NVSmall's real weights written as fp32 and fp16 TRT blobs,
    loaded back with `params_from_trt_blob` and served at 321x1025 in fp32
    (TF32 off, cuDNN's deterministic algorithms) on one frame against the
    .npz net. Returns (blob paths by dtype, the .npz net's disparity)."""
    spec = models.STEREO_SPECS["nvsmall"]
    tree = models.params_from_npz(ROOT / NVSMALL_NPZ)
    SMOKE_DIR.mkdir(parents=True, exist_ok=True)
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        ref_node = nodes.StereoNode(spec, tree, dtype=torch.float32,
                                    device=card)
        ref = ref_node(*frame)
        check(np.array_equal(ref_node(*frame), ref),
              "8a: the fp32 .npz net does not repeat itself bit for bit")
        paths = {}
        for dtype in ("fp32", "fp16"):
            path = SMOKE_DIR / f"nvsmall_{dtype}.trtw"
            io.write_trt_weights(models.params_to_trt_blob(spec, tree), path,
                                 dtype=dtype)
            blob_tree = models.params_from_trt_blob(
                spec, io.read_trt_weights(path, dtype))
            got = nodes.StereoNode(spec, blob_tree, dtype=torch.float32,
                                   device=card)(*frame)
            diff = np.abs(got - ref)
            print(f"8a nvsmall 321x1025 fp32 from the {dtype} TRT blob "
                  f"({path.stat().st_size} bytes) vs the .npz net, one "
                  f"frame: bit-equal {np.array_equal(got, ref)}, mean abs "
                  f"diff {diff.mean():.4e} px, max {diff.max():.4e} px")
            if dtype == "fp32":
                check(np.array_equal(got, ref), "8a: the fp32 blob's net is "
                      "not bit-equal to the .npz net")
            else:
                check(diff.mean() < BLOB_FP16_MEAN and diff.max() <
                      BLOB_FP16_MAX, f"8a: the fp16 blob's net off the .npz "
                      f"net past mean {BLOB_FP16_MEAN} / max {BLOB_FP16_MAX}")
            paths[dtype] = path
    finally:
        torch.backends.cudnn.deterministic = saved
    return paths, ref


def rung_setup(np, models):
    """8b's models (label, spec, weights, packed head) and frames:
    ResNet18-2D with random conditioned weights, NVSmall with the repo's
    real weights under the fused and the packed head; 20 seeded pairs."""
    spec2d = dataclasses.replace(models.STEREO_SPECS["resnet18_2d"],
                                 input_hw=FULL_HW)
    tree2d = conditioned_params(
        np, models.init_stereo_params(spec2d, seed=0), 3)
    spec3d = models.STEREO_SPECS["nvsmall"]
    tree3d = models.params_from_npz(ROOT / NVSMALL_NPZ)
    return ([("resnet18_2d", spec2d, tree2d, False),
             ("nvsmall fused", spec3d, tree3d, False),
             ("nvsmall packed", spec3d, tree3d, True)],
            stereo_frames(np, 8, RUNG_FRAMES))


RUNG_KERNELS = {"resnet18_2d": ("corr_softargmax",),
                "nvsmall fused": ("fused_cv_emit",),
                "nvsmall packed": ("conv223", "fused_cv_emit.packed")}


def rung_gate(np, label, rung, got, ref, top, m):
    """8b's accuracy gate of one rung against its fp32 node
    (`RUNG_READINGS`); returns the figures it read."""
    model = label.split()[0]
    reading = RUNG_READINGS[model][rung]
    if model == "nvsmall":
        epe_gate = RUNG_EPE_FACTOR * reading[0]
        d1_gate = RUNG_D1_FACTOR * reading[1]
        print(f"8b {label} {rung or 'bf16'}: gates EPE < {epe_gate:.4f} px,"
              f" D1 < {d1_gate:.4f} %")
        check(m["epe"] < epe_gate and 100 * m["d1"] < d1_gate,
              f"8b {label} {rung}: EPE {m['epe']} px / D1 {100 * m['d1']} "
              f"% against the fp32 node, past {epe_gate} / {d1_gate}")
        return {}
    free = ref < top * (1.0 - 2.0 ** -9)  # bf16 sigmoid below 1
    err = np.abs(got - ref)[free] / top
    mean, off = float(err.mean()), float((err > 0.01).mean())
    print(f"8b {label} {rung or 'bf16'}: sigmoid units on the "
          f"{free.mean():.4f} share of pixels whose sigmoid is below 1: "
          f"mean {mean:.4e}, share off by more than 0.01 {off:.4e}")
    check(free.mean() >= RUNG_2D_FREE_SHARE, f"8b {label} {rung}: only "
          f"{free.mean()} of the pixels below the sigmoid's saturation")
    gates = (RUNG_2D_MEAN_FACTOR * reading[0],
             RUNG_2D_OFF_FACTOR * reading[1])
    print(f"8b {label} {rung or 'bf16'}: gates mean < {gates[0]:.4e}, "
          f"share off < {gates[1]:.4e}")
    check(mean < gates[0] and off < gates[1], f"8b {label} {rung}: "
          f"sigmoid mean {mean} / share off {off} past {gates}")
    return {"sigmoid_mean_free": mean, "sigmoid_off_share": off,
            "free_share": float(free.mean())}


def rungs_child(np, torch, models, nodes, counters, packed3d_lowering,
                card="cuda"):
    """8b, in a process of its own (`RUNGS_CHILD`) that no profiler has
    traced: each model's bf16 `StereoNode` with quantize None / w8 / int8
    (int8 calibrated on the first pair), 20 frames after 2 warm-up frames,
    every count zeroed just before and read just after; D1 and EPE against
    the same model's fp32 node on the same frames; then each node traced
    for its device busy. Prints one JSON line last."""
    from redtail_tpu_torch.utils.metrics import disparity_errors

    configs, frames = rung_setup(np, models)
    figures, served = {}, []
    for label, spec, tree, packed in configs:
        lowering = packed3d_lowering if packed else contextlib.nullcontext
        top = spec.full_max_disp if not spec.corr else spec.input_hw[1]
        with lowering():
            ref_node = nodes.StereoNode(spec, tree, dtype=torch.float32,
                                    device=card)
            ref = np.stack([ref_node(*f) for f in frames])
            del ref_node
            for rung in RUNGS:
                name = f"{label} bf16 {rung or 'none'}"
                t0 = time.perf_counter()
                node = nodes.StereoNode(
                    spec, tree, dtype=torch.bfloat16, quantize=rung,
                    calib_frames=frames[:1] if rung == "int8" else None,
                    device=card)
                build_s = time.perf_counter() - t0
                outs, counts, med = serve(np, torch, node, frames, counters,
                                          top, f"8b {name}")
                for k in RUNG_KERNELS[label]:
                    check(counts[k] == len(frames), f"8b {name}: {k} "
                          f"launched {counts[k]} times for {len(frames)} "
                          f"frames")
                m = disparity_errors(np.stack(outs), ref,
                                     np.ones_like(ref, bool))
                print(f"8b {name}: against the fp32 node on the same "
                      f"frames, D1 {100 * m['d1']:.4f} %, EPE "
                      f"{m['epe']:.4f} px, max {m['err_max']:.3f} px; node "
                      f"built in {build_s:.2f} s"
                      f"{' (int8 calibration included)' if rung == 'int8' else ''}")
                gate = rung_gate(np, label, rung, np.stack(outs), ref, top, m)
                figures[name] = {
                    "latency_median_ms": med, "d1": m["d1"],
                    "epe": m["epe"], "err_max": m["err_max"], **gate,
                    "launches": {k: counts[k] for k in (
                        "corr_softargmax", "corr_cost_volume",
                        "fused_cv_emit", "fused_cv_emit.packed", "conv223",
                        "cost_volume_concat")}}
                served.append((name, node, lowering, med))
    print_clocks("the rung phase's serving")
    for name, node, lowering, med in served:  # traced last: see 7b
        with lowering():
            traced = trace_frames(torch, node, frames[:3], med, table=False)
        check(traced is not None, f"8b {name}: no device time traced")
        busy, ops = traced
        figures[name].update(busy_ms=busy, idle_share=1 - busy / med,
                             device_launches=ops)
    print(json.dumps({"rungs": figures}))


def phase_rungs(np):
    """8b in a fresh process (`rungs_child`); returns its figures."""
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                           RUNGS_CHILD], capture_output=True, text=True,
                          timeout=900, cwd=ROOT)
    print(proc.stdout.rstrip())
    check(proc.returncode == 0, f"the 8b process exited {proc.returncode}: "
          f"{proc.stderr[-3000:]}")
    figures = json.loads(proc.stdout.strip().splitlines()[-1])["rungs"]
    print(f"8b rung table ({nvidia_smi('name,power.limit')}; latency: "
          f"host clock, median of {RUNG_FRAMES} frames; busy: torch.profiler"
          f" over 3 frames, traced after every rung was timed):")
    print(f"  {'model / rung':34s} {'median ms':>10s} {'busy ms':>9s} "
          f"{'idle':>6s} {'D1 %':>8s} {'EPE px':>8s}  launches")
    for name, f in figures.items():
        kernels = {k: v for k, v in f["launches"].items() if v}
        print(f"  {name:34s} {f['latency_median_ms']:10.3f} "
              f"{f['busy_ms']:9.3f} {f['idle_share']:6.3f} "
              f"{100 * f['d1']:8.4f} {f['epe']:8.4f}  {kernels}")
    return figures


def ulps_apart(torch, got, want):
    """Per element, how many bf16 steps apart two bf16 tensors are."""
    def ordered(t):
        bits = t.to(torch.bfloat16).contiguous().view(torch.int16).int()
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return (ordered(got.cpu()) - ordered(want.cpu())).abs()


def phase_quant_card_vs_cpu(np, torch, models, ptq, stereo_int8, conv,
                            c223, emit, card="cuda"):
    """8c: the card against the CPU on the same seeded inputs and scales:
    `conv2d_int8` and `quantize_act` bit-equal on both routes (K below and
    above the 2**24 bound); the int8 nets (ResNet18-2D at 129x257, NVTiny
    at 65x129, scales calibrated once on the CPU) within stated gates; the
    bf16 round-once convs within one bf16 step; and the two CUDA kernels
    that end in a conv epilogue shown to add their bias before their one
    rounding."""
    rs = np.random.RandomState(11)
    for c_in, shape, stride in ((32, (1, 161, 513), 1), (32, (2, 9, 11), 2),
                                (128, (1, 21, 40), 1), (256, (2, 9, 11), 2),
                                (256, (1, 3, 3), 1)):
        k = 9 * c_in
        x = rs.randint(-127, 128, (shape[0], c_in) + shape[1:]).astype(
            np.int8)
        w = rs.randint(-127, 128, (24, c_in, 3, 3)).astype(np.int8)
        x[0, :, 0, 0] = 127
        w[0] = 127
        ws = torch.from_numpy(((rs.rand(24) + 0.5) * 1e-3).astype(np.float32))
        b = torch.from_numpy(rs.randn(24).astype(np.float32))
        outs = [ptq.conv2d_int8_nchw(
            torch.from_numpy(x).to(dev), torch.from_numpy(w).to(dev),
            x_scale=0.0123, w_scale=ws, bias=b.to(dev), stride=stride,
            padding="SAME" if shape[1] > 3 else "VALID",
            out_dtype=torch.float32).cpu() for dev in (card, "cpu")]
        route = "fp32 carriers" if k <= ptq.EXACT_FP32_K else "torch._int_mm"
        print(f"8c conv2d_int8 K={k} ({route}) x {tuple(x.shape)} stride "
              f"{stride}: card vs CPU bit-equal {torch.equal(*outs)}")
        check(torch.equal(*outs), f"8c conv2d_int8 K={k}: card off the CPU")
    xf = torch.from_numpy((rs.randn(1, 32, 161, 513) * 3).astype(np.float32))
    for scale in (0.5, 0.0371):
        q = [ptq.quantize_act(xf.to(dev), scale).cpu()
             for dev in (card, "cpu")]
        check(torch.equal(*q), f"8c quantize_act at {scale}: card off CPU")
    print("8c quantize_act (1, 32, 161, 513) at scales 0.5 and 0.0371: card "
          "vs CPU bit-equal")

    for name, hw, disp in (("resnet18_2d", (129, 257), 16),
                           ("nvtiny", SLICE_3D_HW, SLICE_3D_DISP)):
        spec = dataclasses.replace(models.STEREO_SPECS[name], input_hw=hw,
                                   max_disp=disp)
        tree = conditioned_params(np, models.init_stereo_params(spec, seed=4),
                                  5)
        pairs = [tuple(rs.rand(*hw, 3).astype(np.float32) for _ in range(2))]
        scales = stereo_int8.calibrate_stereo(spec, tree, pairs,
                                              device="cpu")
        qtree = stereo_int8.quantize_stereo_params_int8(tree, scales)
        left, right = (torch.from_numpy(a[None]) for a in pairs[0])
        with torch.inference_mode():
            want = models.params_from_numpy(spec, qtree, device="cpu")(
                left, right)
            got = {dt: models.params_from_numpy(spec, qtree, device=card,
                                                dtype=dt)(
                left.to(card, dt), right.to(card, dt)).float().cpu()
                for dt in (torch.float32, torch.bfloat16)}
        unit = "sigmoid units" if spec.corr else "px"
        g32, g16 = (INT8_2D_GATES if spec.corr else INT8_3D_GATES)
        e32 = (got[torch.float32] - want).abs()
        e16 = (got[torch.bfloat16] - want).abs()
        print(f"8c int8 {name} {hw[0]}x{hw[1]} ({len(scales)} int8 layers), "
              f"card vs CPU fp32: fp32 mean {e32.mean():.3e} max "
              f"{e32.max():.3e} {unit} (gate mean {g32}); bf16 mean "
              f"{e16.mean():.3e} max {e16.max():.3e} (gate mean {g16})")
        check(e32.mean() < g32 and e16.mean() < g16,
              f"8c int8 {name}: card off the CPU past the gates")

    gen = torch.Generator().manual_seed(12)
    for label, xs, ws, kw in ROUND_ONCE_CASES:
        fn = getattr(conv, label)
        x = torch.randn(xs, generator=gen).to(torch.bfloat16)
        w = (torch.randn(ws, generator=gen) / 12).to(torch.bfloat16)
        b = torch.randn(ws[-2] if "transpose" in label else ws[-1],
                        generator=gen).to(torch.bfloat16)
        with torch.inference_mode():
            got = fn(x.to(card), w.to(card), b.to(card), **kw)
            want = fn(x, w, b, **kw)
        steps = ulps_apart(torch, got, want)
        ok = bf16_ulp_ok(torch, got.cpu(), want, FP32_ATOL)
        print(f"8c round-once bf16 {label} {tuple(x.shape)}: card vs CPU "
              f"within one bf16 step plus {FP32_ATOL} (the fp32 sums' "
              f"order, near zero): {ok}; at most {int(steps.max())} "
              f"step(s) apart, {float((steps > 0).float().mean()):.2e} of "
              f"the elements differ")
        check(ok, f"8c {label}: card off the CPU past one bf16 step")

    # conv223 and the emission: their bias goes into the fp32 sum before
    # the one rounding: each stays within a step of the single-rounding
    # plain version and matches it on more elements than a double rounding
    xshape, c_out = EPILOGUE_CONV223
    xp = torch.randn(xshape, generator=gen).to(torch.bfloat16)
    k = (torch.randn((2, 2, 3, xshape[-1], c_out), generator=gen)
         * xshape[-1] ** -0.5).to(torch.bfloat16)
    bias = (torch.randn(c_out, generator=gen) * 3).to(torch.bfloat16)
    nhw, k_emit, d_emit = EPILOGUE_EMIT
    la = torch.randn(nhw + (3 * k_emit,), generator=gen).to(torch.bfloat16)
    rb = torch.randn(nhw + (6 * k_emit,), generator=gen).to(torch.bfloat16)
    ebias = (torch.randn(k_emit, generator=gen) * 3).to(torch.bfloat16)
    for name, kernel, once, bare in (
            ("conv223", lambda: c223.conv223(xp.to(card), k.to(card),
                                             bias.to(card)),
             lambda: c223.conv223_plain(xp.to(card), k.to(card), bias.to(card)),
             lambda: c223.conv223_plain(xp.to(card), k.to(card), None)),
            ("fused_cv_emit", lambda: emit.fused_cv_emit(
                la.to(card), rb.to(card), ebias.to(card), d_emit, elu=False),
             lambda: emit.fused_cv_emit_plain(
                 la.to(card), rb.to(card), ebias.to(card), d_emit,
                 elu=False),
             lambda: emit.fused_cv_emit_plain(
                 la.to(card), rb.to(card), None, d_emit, elu=False))):
        b = bias if name == "conv223" else ebias
        with torch.inference_mode():
            got, want = kernel(), once()
            twice = (bare().float() + b.to(card).float()).to(torch.bfloat16)
        steps = ulps_apart(torch, got, want)
        off_once = int((got != want).sum())
        off_twice = int((got != twice).sum())
        ok = bf16_ulp_ok(torch, got, want, FP32_ATOL)
        print(f"8c {name} bf16 epilogue: against the plain version (fp32 sum"
              f" + bias, one rounding) within one step plus {FP32_ATOL}: "
              f"{ok}, at most {int(steps.max())} step(s), {off_once} of "
              f"{got.numel()} elements differ; against a double rounding "
              f"(sum rounded, + bias, rounded) {off_twice} differ")
        check(ok and off_once < off_twice,
              f"8c {name}: its bias is not added before its one rounding")


def carrier_conv2d(torch, x_q, w_q, stride, pads):
    """An int8 conv's exact sum by cuDNN on fp32 carriers, TF32 allowed
    (exact while K * 127**2 < 2**24, as every stereo int8 layer's is),
    deterministic algorithms: the library call 8c times `conv2d_int8_acc`
    against."""
    import torch.nn.functional as F
    x = x_q.float()
    if any(lo != hi for lo, hi in pads):
        x = F.pad(x, [pads[1][0], pads[1][1], pads[0][0], pads[0][1]])
        pads = ((0, 0), (0, 0))
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=True):
        return F.conv2d(x, w_q.float(), stride=stride,
                        padding=(pads[0][0], pads[1][0]))


def phase_int8_routes(np, torch, models, nodes, ptq, card="cuda"):
    """8c at full size: every int8 layer of ResNet18-2D's and NVSmall's
    int8 rung (8b's nets, calibrated on 8b's first pair, bf16 at
    321x1025), its quantized input caught on the way in on 8b's first
    frame; the exact sum of each by `conv2d_int8_acc` (the port), by
    im2col + `torch._int_mm` and by cuDNN on fp32 carriers, all three
    bit-equal; each distinct layer shape timed (CUDA events, L2 evicted).
    Returns {model: per-frame ms of the three}."""
    configs, frames = rung_setup(np, models)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=card)
    totals = {}
    for label, spec, tree, packed in configs:
        if packed:  # the packed head's int8 layers are the fused head's
            continue
        node = nodes.StereoNode(spec, tree, dtype=torch.bfloat16,
                                quantize="int8", calib_frames=frames[:1],
                                device=card)
        caught = []

        def catch(mod, args, caught=caught):
            caught.append((ptq.quantize_act(args[0], mod.x_scale),
                           mod.weight_q, (mod.stride, mod.stride)))
        hooks = [m.register_forward_pre_hook(catch)
                 for m in node.net.modules()
                 if type(m).__name__ == "_Int8Conv"]
        node(*frames[0])
        for h in hooks:
            h.remove()
        check(caught, f"8c {label}: no int8 layer ran")
        timed, total = {}, np.zeros(3)
        for x_q, w_q, stride in caught:
            pads = ptq._conv_pads("SAME", x_q.shape[2:], w_q.shape[2:],
                                  stride)
            fns = (lambda: ptq.conv2d_int8_acc(x_q, w_q, stride=stride),
                   lambda: ptq._int_mm_conv(x_q, w_q, stride, pads).float(),
                   lambda: carrier_conv2d(torch, x_q, w_q, stride, pads))
            key = (tuple(x_q.shape), tuple(w_q.shape), stride)
            with torch.inference_mode():
                outs = [f() for f in fns]
            check(all(torch.equal(outs[0], o) for o in outs[1:]),
                  f"8c int8 routes {label} {key}: not bit-equal")
            if key not in timed:
                with torch.inference_mode():
                    timed[key] = [cuda_ms(torch, f, flush,
                                          label=f"8c int8 {key}")
                                  for f in fns]
            total += timed[key]
        k_max = max(w.shape[1] * w.shape[2] * w.shape[3]
                    for _, w, _ in caught)
        print(f"8c int8 routes {label} {FULL_HW[0]}x{FULL_HW[1]} bf16, "
              f"{len(caught)} int8 layers (K <= {k_max}), all three routes "
              f"bit-equal; device ms (CUDA events, L2 evicted, median of "
              f"{TIMING_REPS}): conv2d_int8_acc / im2col + torch._int_mm / "
              f"cuDNN fp32 carriers:")
        for key, t in timed.items():
            n = sum(1 for x, w, st in caught
                    if (tuple(x.shape), tuple(w.shape), st) == key)
            print(f"  x {key[0]} w {key[1]} stride {key[2][0]} (x{n}): "
                  f"{t[0]:.4f} / {t[1]:.4f} / {t[2]:.4f}")
        print(f"  per frame: {total[0]:.4f} / {total[1]:.4f} / "
              f"{total[2]:.4f} ms")
        totals[label.split()[0]] = [float(t) for t in total]
        del node, caught
    print_clocks("the int8 route timing")
    return totals


def phase_app(np, blob_fp16, golden, frame, extra=()):
    """8d: `stereo_app` in a subprocess: NVSmall from the fp16 TRT blob,
    bf16, int8, with the accuracy table against 8a's fp32 disparity of the
    same pair (written as lossless PNGs)."""
    import cv2

    left, right = SMOKE_DIR / "pair_left.png", SMOKE_DIR / "pair_right.png"
    cv2.imwrite(str(left), frame[0])
    cv2.imwrite(str(right), frame[1])
    gold = SMOKE_DIR / "nvsmall_fp32_disp.npy"
    np.save(gold, golden)
    argv = [sys.executable, "-m", "redtail_tpu_torch.apps.stereo_app",
            "nvsmall", "--weights", str(blob_fp16), "--weights-dtype",
            "fp16", "--dtype", "bf16", "--quantize", "int8", "--accuracy",
            str(gold), "--hw", *map(str, FULL_HW), "--left", str(left),
            "--right", str(right), "--out", str(SMOKE_DIR / "app_disp"),
            *extra]
    t0 = time.perf_counter()
    proc = subprocess.run(argv, capture_output=True, text=True, timeout=600,
                          cwd=ROOT)
    print(f"8d {' '.join(argv[1:4])} ... --quantize int8 --accuracy "
          f"({time.perf_counter() - t0:.1f} s): exit {proc.returncode}")
    print(proc.stderr.rstrip()[-2000:])
    check(proc.returncode == 0, f"8d stereo_app exited {proc.returncode}")
    rows = [json.loads(s)["accuracy"] for s in proc.stdout.splitlines()
            if s.startswith("{") and "accuracy" in s]
    check(len(rows) == 1 and [r["rung"] for r in rows[0]] == [
        "fp32", "bf16", "bf16+packed", "w8", "int8"],
        f"8d: the accuracy rows are {rows}")
    print(f"8d accuracy rows: {json.dumps(rows[0])}")
    return rows[0]


def print_repair_cost(figures):
    """8e: device busy per frame after the round-once repair (8b's bf16
    rung without quantization) beside the same paths' figures before the
    repair."""
    print(f"8e round-once repair, device busy per frame ({nvidia_smi('name,power.limit')}"
          f"; before: measured by phase 5 before the repair, NVIDIA H100 "
          f"80GB HBM3 at 700 W):")
    for name, before in BEFORE_REPAIR_BUSY_MS.items():
        after = figures[f"{name} bf16 none"]["busy_ms"]
        print(f"  {name:16s} before {before:8.3f} ms, after {after:8.3f} ms "
              f"({after / before:.3f}x)")


# ------------------------------------------------------------------ phase 9

# The training path: the 160x512 crop at batch 4, the JAX package's own
# training bench configuration (README "Training"), whose features are
# (4, 80, 256, C) at half resolution; 20 bf16 steps of each stereo model.
TRAIN_CROP, TRAIN_BATCH, TRAIN_STEPS = (160, 512), 4, 20
TRAIN_FEATS = {"resnet18_2d": ((4, 80, 256, 32), 48),
               "nvtiny": ((4, 80, 256, 8), 24),
               "nvsmall": ((4, 80, 256, 32), 48)}
# 9a: the corr backward at the training shape, then the forward kernel's
# edges (phase 3's), then its own plan's (`bwd_tile_plan`): rows of several
# segments with their halos, C = 12 (no 16-byte loads in bf16), D = 70 in
# two disparity chunks; the concat backward at NVTiny's and NVSmall's
# training shapes, then the forward's edges, then C not a multiple of 8
# (8-, 4- and 2-byte words)
CORR_BWD_CASES = (("resnet18_2d train",) + TRAIN_FEATS["resnet18_2d"],) \
    + CORR_CASES[1:] + (("segments", (2, 3, 150, 32), 48),
                        ("C=12 segments", (1, 2, 200, 12), 20),
                        ("D=70 segments", (1, 2, 300, 16), 70))
CONCAT_BWD_CASES = (("nvtiny train",) + TRAIN_FEATS["nvtiny"],
                    ("nvsmall train",) + TRAIN_FEATS["nvsmall"]) \
    + CONCAT_CASES[2:] + (("C=12", (1, 3, 40, 12), 9),
                          ("C=5", (2, 5, 70, 5), 7))
# the backwards against their plain versions: fp32 within this share of the
# largest magnitude (+1), the summation order only; bf16 within one bf16
# step on top (both round one fp32 sum once)
BWD_RTOL = 1e-5
# 9b: a train step on the card against the CPU at this crop, batch 2: each
# gradient leaf, fp32 within this share of its largest magnitude (cuDNN
# with TF32 off and the kernels sum in other orders; the corr model's
# soft-argmax and sigmoid amplify); bf16 within these relative L2 distances
# of the CPU's bf16 leaf, each set between the sound step's worst leaf and
# a deliberately wrong step's (its backward kernel's dR zeroed), both read
# on an NVIDIA H100 80GB HBM3 at 700 W: ResNet18-2D sound 4.27e-2, wrong
# 0.558; NVTiny sound 4.24e-3, wrong 0.557, and its fp32 step 1.51e-2 from
# the CPU's bf16. ResNet18-2D's fp32 step reads 4.05e-2 from the CPU's
# bf16, no farther than the sound bf16 step: its bf16 gradient moves with
# the summation order as much as with the roundings, so there the gate
# holds the kernels, not the roundings, which NVTiny's gate holds on the
# same convs. The
# leaf whose exact gradient is 0 (the 3D models' last bias: the soft-argmin
# ignores a shift) within this share of the model's largest gradient
TRAIN_SLICE_CROP = (64, 128)
TRAIN_FP32_RTOL, TRAIN_ZERO_SHARE = 1e-3, 1e-3
TRAIN_BF16_GATE = {"resnet18_2d": 0.1, "nvtiny": 8e-3}
ZERO_GRAD_LEAF = "decoder3D/deconv3D_3/biases"
TRAIN_TIMED_STEPS = 10


def bwd_ok(torch, got, want):
    atol = BWD_RTOL * (want.float().abs().max().item() + 1.0)
    if got.dtype == torch.float32:
        return bool(((got - want).abs() <= atol).all())
    return bf16_ulp_ok(torch, got, want, atol)


def phase_corr_bwd(torch, corr, gen):
    """9a: the corr backward kernel against its plain version at every
    case, both dtypes, for the fused soft-argmax (the main path) and both
    volume layouts, and a second launch on the same inputs bit-equal to the
    first; then each timed at the ResNet18-2D training call."""
    max_err = {"softargmax": 0.0, "dlast": 0.0, "hdw": 0.0}
    for name, shape, d in CORR_BWD_CASES:
        n, h, w, _ = shape
        for dtype in (torch.bfloat16, torch.float32):
            left, right = (_randn(torch, gen, shape, dtype)
                           * shape[-1] ** -0.5 for _ in range(2))
            errs = []
            for mode, gshape in (("softargmax", (n, h, w)),
                                 ("dlast", (n, h, w, d)),
                                 ("hdw", (n, h, d, w))):
                g = _randn(torch, gen, gshape, dtype if mode == "hdw"
                           else torch.float32)
                if mode == "softargmax":
                    got, again = (corr.corr_softargmax_bwd(left, right, g, d)
                                  for _ in range(2))
                    torch.cuda.synchronize()
                    want = corr.corr_softargmax_bwd_plain(left, right, g, d)
                else:
                    got, again = (corr.corr_cost_volume_bwd(
                        left, right, g, d, layout=mode) for _ in range(2))
                    torch.cuda.synchronize()
                    want = corr.corr_cost_volume_bwd_plain(left, right, g, d,
                                                           layout=mode)
                check(all(torch.equal(a, b) for a, b in zip(got, again)),
                      f"corr bwd {name} {dtype} {mode}: two launches on the "
                      f"same inputs differ")
                for a, b in zip(got, want):
                    check(a.shape == b.shape == shape and a.dtype == b.dtype
                          == dtype, f"corr bwd {name} {mode}: {a.shape} "
                          f"{a.dtype} vs {b.shape} {b.dtype}")
                    err = (a.float() - b.float()).abs().max().item()
                    check(bwd_ok(torch, a, b), f"corr bwd {name} {dtype} "
                          f"{mode}: max abs err {err} past the gate")
                    errs.append(f"{mode} {err:.2e}")
                    if dtype == torch.float32:
                        max_err[mode] = max(max_err[mode], err)
            print(f"9a corr bwd {name:17s} {str(shape):18s} D={d:<3d} "
                  f"{str(dtype):15s} dL, dR max abs err: {', '.join(errs)} "
                  f"(gate {BWD_RTOL} x (max + 1), bf16 + 1 step); two "
                  f"launches bit-equal")

    _, shape, d = CORR_BWD_CASES[0]
    n, h, w, c = shape
    left, right = (_randn(torch, gen, shape, torch.bfloat16)
                   * c ** -0.5 for _ in range(2))
    feats = 4 * left.numel() * left.element_size()  # L, R in; dL, dR out
    valid = n * h * sum(max(w - k, 0) for k in range(d))
    modes = []
    # dL and dR: 4 c flops a volume entry, fp32 products on CUDA cores; the
    # fused form's recompute: 2 c more, bf16 on the tensor cores
    grad_flops = 4 * c * valid
    for mode, g_bytes, rec_flops, gshape, gdtype in (
            ("softargmax", n * h * w * 4, 2 * c * valid, (n, h, w),
             torch.float32),
            ("dlast", n * h * w * d * 4, 0, (n, h, w, d), torch.float32),
            ("hdw", n * h * w * d * 2, 0, (n, h, d, w), torch.bfloat16)):
        g = _randn(torch, gen, gshape, gdtype)
        if mode == "softargmax":
            kernel = lambda: corr.corr_softargmax_bwd(left, right, g, d)  # noqa
            plain = lambda: corr.corr_softargmax_bwd_plain(  # noqa: E731
                left, right, g, d)
        else:
            kernel = lambda: corr.corr_cost_volume_bwd(  # noqa: E731
                left, right, g, d, layout=mode)
            plain = lambda: corr.corr_cost_volume_bwd_plain(  # noqa: E731
                left, right, g, d, layout=mode)
        # the operations term in fp32-rate time: the recompute's bf16
        # flops count at the fp32 / bf16 rate ratio
        timed = time_kernel(torch, f"9a corr bwd {mode} at {shape} D={d} "
                            f"bf16", kernel, plain, feats + g_bytes,
                            grad_flops + rec_flops * PEAK_FP32_FLOPS
                            / PEAK_BF16_FLOPS)
        # the bound with every flop at the bf16 tensor-core rate
        bf16_ms, _ = bound(feats + g_bytes, grad_flops + rec_flops,
                           PEAK_BF16_FLOPS)
        print(f"9a corr bwd {mode}: operations {grad_flops / 1e9:.3f} GFLOP "
              f"fp32 + {rec_flops / 1e9:.3f} GFLOP bf16; with every flop at "
              f"the bf16 rate the bound is {bf16_ms:.5f} ms, share "
              f"{bf16_ms / timed['ms']:.3f}")
        modes.append({"mode": mode, "max_abs_err": max_err[mode], **timed,
                      "bound_ms_bf16_rate": bf16_ms,
                      "bound_share_bf16_rate": bf16_ms / timed["ms"]})
    entry = {"name": "corr_bwd", "route": "cuda",
             "source": "redtail_tpu_torch/csrc/corr_cost_volume_bwd.cu",
             "replaces": "redtail_tpu/kernels/cost_volume_pallas.py:113",
             "launches": None, "max_abs_err": max_err["softargmax"]}
    entry.update({k: v for k, v in modes[0].items()
                  if k not in ("mode", "max_abs_err")})
    entry["modes"] = modes
    return entry


def phase_concat_bwd(torch, concat, gen):
    """9a: the concat backward kernel against its plain version, both
    dtypes, and a second launch on the same inputs bit-equal to the first;
    then timed at NVTiny's training call (the main path's) and NVSmall's."""
    max_err = 0.0
    for name, shape, d in CONCAT_BWD_CASES:
        n, h, w, c = shape
        for dtype in (torch.bfloat16, torch.float32):
            g = _randn(torch, gen, (n, d, h, w, 2 * c), dtype)
            got, again = (concat.cost_volume_concat_bwd(g, d)
                          for _ in range(2))
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"concat bwd {name} {dtype}: two launches on the same "
                  f"inputs differ")
            want = concat.cost_volume_concat_bwd_plain(g, d)
            errs = []
            for a, b in zip(got, want):
                check(a.shape == b.shape == shape and a.dtype == b.dtype
                      == dtype, f"concat bwd {name}: {a.shape} {a.dtype}")
                err = (a.float() - b.float()).abs().max().item()
                check(bwd_ok(torch, a, b), f"concat bwd {name} {dtype}: max "
                      f"abs err {err} past the gate")
                errs.append(err)
                if dtype == torch.float32:
                    max_err = max(max_err, err)
            print(f"9a concat bwd {name:14s} {str(shape):18s} D={d:<3d} "
                  f"{str(dtype):15s} dL, dR max abs err {errs[0]:.2e}, "
                  f"{errs[1]:.2e} (gate {BWD_RTOL} x (max + 1), bf16 + 1 "
                  f"step); two launches bit-equal")
    timed = {}
    for name, shape, d in CONCAT_BWD_CASES[:2]:
        n, h, w, c = shape
        g = _randn(torch, gen, (n, d, h, w, 2 * c), torch.bfloat16)
        nbytes = g.numel() * 2 + 2 * n * h * w * c * 2
        adds = n * h * w * c * d + n * h * c * sum(max(w - k, 0)
                                                   for k in range(d))
        timed[name] = time_kernel(
            torch, f"9a concat bwd {name} at {shape} D={d} bf16",
            lambda: concat.cost_volume_concat_bwd(g, d),
            lambda: concat.cost_volume_concat_bwd_plain(g, d), nbytes, adds)
    first = CONCAT_BWD_CASES[0][0]
    return {"name": "concat_bwd", "route": "cuda",
            "source": "redtail_tpu_torch/csrc/cost_volume_concat_bwd.cu",
            "replaces": "redtail_tpu/kernels/cost_volume_pallas.py:158",
            "note": "the Pallas concat kernel has no VJP; the JAX package "
                    "trains through XLA's gradient of "
                    "redtail_tpu/ops/cost_volume.py:27",
            "launches": None, "max_abs_err": max_err, **timed[first],
            "shapes": [{"case": k, **v} for k, v in timed.items()]}


def _leaves(tree, path=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{path}/{k}".lstrip("/"))
        else:
            yield f"{path}/{k}".lstrip("/"), v


def train_batch(np, hw, n, seed):
    """A seeded stereo batch: images in [0, 1], disparity targets in px,
    a validity mask."""
    rs = np.random.RandomState(seed)
    left, right = (rs.rand(n, *hw, 3).astype(np.float32) for _ in range(2))
    target = (rs.rand(n, *hw) * 12).astype(np.float32)
    valid = (rs.rand(n, *hw) > 0.3).astype(np.float32)
    return left, right, target, valid


@contextlib.contextmanager
def zero_dr(module, name):
    """Inside the block the backward wrapper ``module.name`` returns (dL,
    0): the wrong step 9b's bf16 gate must catch."""
    right = getattr(module, name)

    def wrong(*args):
        dl, dr = right(*args)
        return dl, dr.new_zeros(dr.shape)
    wrong.launches = 0  # the wrapper counts on the name it is called by
    setattr(module, name, wrong)
    try:
        yield
    finally:
        setattr(module, name, right)


def leaf_rel_l2(np, got, want):
    """{leaf: |got - want| / |want|} over the leaves of ``want`` but the
    one whose exact gradient is 0."""
    return {k: np.linalg.norm(got[k] - w) / np.linalg.norm(w)
            for k, w in want.items() if k != ZERO_GRAD_LEAF}


def phase_train_slice(np, torch, models, ptrain, counters, card="cuda"):
    """9b: one train step's loss and gradients, card against CPU, fp32 and
    bf16, ResNet18-2D and NVTiny at `TRAIN_SLICE_CROP`, batch 2, the same
    numpy params; the step's backward kernel launched once on the card.
    bf16 against the CPU's bf16 under `TRAIN_BF16_GATE`, which a step with
    the backward kernel's dR zeroed must fail."""
    from redtail_tpu_torch.kernels import corr_cost_volume, cost_volume_concat

    batch = train_batch(np, TRAIN_SLICE_CROP, 2, 5)
    for name, bwd, module in (
            ("resnet18_2d", "corr_softargmax_bwd", corr_cost_volume),
            ("nvtiny", "cost_volume_concat_bwd", cost_volume_concat)):
        spec = dataclasses.replace(models.STEREO_SPECS[name],
                                   input_hw=TRAIN_SLICE_CROP)
        tree = conditioned_params(np, models.init_stereo_params(spec, seed=1),
                                  2)

        def step(dtype, dev):
            init_fn, _ = ptrain.make_train_step(spec, compute_dtype=dtype,
                                                device=dev)
            state = init_fn(tree)
            loss, _ = ptrain.stereo_loss(spec, state.params, *batch)
            loss.backward()
            return float(loss.detach()), dict(_leaves(
                models.params_to_numpy(state.params, grads=True)))

        out = {}
        for dtype in (torch.float32, torch.bfloat16):
            for dev in ("cpu", card):
                zero_counts(counters)
                out[dtype, dev] = step(dtype, dev)
                if dev != "cpu":
                    torch.cuda.synchronize()
                    counts = read_counts(counters)
                    check(counts[bwd] == 1, f"9b {name}: {bwd} launched "
                          f"{counts[bwd]} times in one step")
        for dtype in (torch.float32, torch.bfloat16):
            (l_cpu, g_cpu), (l_card, g_card) = (out[dtype, "cpu"],
                                                out[dtype, card])
            top = max(np.abs(v).max() for v in g_cpu.values())
            if ZERO_GRAD_LEAF in g_cpu:
                zero = max(np.abs(g[ZERO_GRAD_LEAF]).max()
                           for g in (g_cpu, g_card))
                check(zero <= TRAIN_ZERO_SHARE * top, f"9b {name} {dtype} "
                      f"{ZERO_GRAD_LEAF}: {zero}, not near 0")
            if dtype == torch.float32:
                errs = {k: np.abs(g_card[k] - w).max() / np.abs(w).max()
                        for k, w in g_cpu.items() if k != ZERO_GRAD_LEAF}
                gate, kind = TRAIN_FP32_RTOL, "max abs / leaf max"
            else:
                errs = leaf_rel_l2(np, g_card, g_cpu)
                gate, kind = TRAIN_BF16_GATE[name], "relative L2"
            path = max(errs, key=errs.get)
            check(errs[path] <= gate, f"9b {name} {dtype} {path}: card off "
                  f"CPU by {errs[path]} (gate {gate})")
            rel = abs(l_card - l_cpu) / abs(l_cpu)
            check(rel <= (1e-4 if dtype == torch.float32 else 1e-2),
                  f"9b {name} {dtype}: loss {l_card} vs CPU {l_cpu}")
            print(f"9b train step {name} {TRAIN_SLICE_CROP[0]}x"
                  f"{TRAIN_SLICE_CROP[1]} b2 {str(dtype):14s}: loss card "
                  f"{l_card:.6f} CPU {l_cpu:.6f} (rel {rel:.2e}); worst "
                  f"gradient leaf {kind} {errs[path]:.3e} ({path}; gate "
                  f"{gate}), {len(g_cpu)} leaves; {bwd} once")

        # the gate against wrong steps: dR zeroed must fail it; the fp32
        # step and the CPU's own fp32 are printed beside it
        g_bf16 = out[torch.bfloat16, "cpu"][1]
        with zero_dr(module, bwd):
            wrong = max(leaf_rel_l2(np, step(torch.bfloat16, card)[1],
                                    g_bf16).values())
        fp32 = max(leaf_rel_l2(np, out[torch.float32, card][1],
                               g_bf16).values())
        cpu = max(leaf_rel_l2(np, g_bf16,
                              out[torch.float32, "cpu"][1]).values())
        check(wrong > TRAIN_BF16_GATE[name], f"9b {name}: a step with {bwd}'s "
              f"dR zeroed reads {wrong} from the CPU's bf16, inside the gate "
              f"{TRAIN_BF16_GATE[name]}")
        print(f"9b {name} bf16 gate {TRAIN_BF16_GATE[name]} against the "
              f"CPU's bf16, worst leaf relative L2: {bwd}'s dR zeroed "
              f"{wrong:.3e} (must fail); the card's fp32 step {fp32:.3e}; "
              f"the CPU's bf16 from its fp32 {cpu:.3e}")


def write_trails(np, root, per_class=6):
    """A trails tree the net can learn: each class a horizontal ramp of its
    own direction (left-dark, flat, right-dark) under noise, so a flip
    maps one side class on the other as the label remap does."""
    import cv2

    rs = np.random.RandomState(0)
    h, w = 180, 320
    ramp = np.linspace(-1.0, 1.0, w)[None, :, None]
    for label, cls in enumerate(("lc", "sc", "rc")):
        d = root / "vid0" / cls
        d.mkdir(parents=True, exist_ok=True)
        for i in range(per_class):
            img = 128 + 80 * (1 - label) * ramp + rs.randn(h, w, 3) * 30
            cv2.imwrite(str(d / f"{i}.png"), np.clip(img, 0, 255).astype(
                np.uint8))
    return root


def run_app(train_app, argv):
    """`train_app.main(argv)` in this process, its JSON records parsed."""
    buf = stdio.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = train_app.main(argv)
    secs = time.perf_counter() - t0
    print(buf.getvalue().rstrip()[-1500:])
    check(rc == 0, f"train_app {argv[0]} exited {rc}")
    return [json.loads(s) for s in buf.getvalue().splitlines()
            if s.startswith("{")], secs


def time_train_steps(torch, step, label):
    """9c: the median host time of ``step()`` (each ends in a sync) after 3
    warm-up steps, peak device memory over them, and device busy / idle
    share and the busiest kernels over 3 more in a `torch.profiler`
    window."""
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(TRAIN_TIMED_STEPS):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    med = statistics.median(times)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    traced = trace_frames(torch, lambda: (step(), torch.cuda.synchronize()),
                          [()] * 3, med)
    busy, launches = traced if traced else (None, None)
    print(f"9c {label}: step median {med:.3f} ms over {TRAIN_TIMED_STEPS} "
          f"(min {min(times):.3f}, max {max(times):.3f}); device busy "
          f"{busy if busy is None else round(busy, 3)} ms a step, idle share "
          f"{None if busy is None else round(1 - busy / med, 3)}, "
          f"{launches} device ops a step; peak device memory {peak:.3f} GiB "
          f"({nvidia_smi('name,power.limit')})")
    print_clocks(f"the {label} steps")
    return {"step_ms": med, "busy_ms": busy,
            "idle_share": None if busy is None else 1 - busy / med,
            "device_ops": launches, "peak_gib": peak}


def phase_train_main(np, torch, models, ptrain, tstereo, ttrail, train_app,
                     kitti, nodes, ckpt, counters, card="cuda",
                     crop=TRAIN_CROP, batch=TRAIN_BATCH, steps=TRAIN_STEPS):
    """9c: the main path, `train_app` as a user runs it, at full width:
    ResNet18-2D, then NVTiny, bf16, ``steps`` steps each on a synthetic
    KITTI tree, the counts zeroed just before and read just after; the loss
    on a fixed batch falls from the init to the trained params; --resume;
    the --out params served; then TrailNet at 180x320, batch 16. Returns
    {kernel counter: {path: launches}} and the figures."""
    root = SMOKE_DIR / "train"
    data = kitti.make_synthetic_kitti(
        root / "kitti", n=2 * batch, hw=(crop[0] + 16, crop[1] + 32),
        disp=(4.0, 20.0), seed=0, octaves=3)
    dev = [] if card == "cuda" else ["--cpu"]
    by_path, figures = {}, {}
    for name, kernels in (("resnet18_2d", ("corr_softargmax",
                                           "corr_softargmax_bwd")),
                          ("nvtiny", ("cost_volume_concat",
                                      "cost_volume_concat_bwd"))):
        out, ck = root / f"{name}.npz", root / f"ck_{name}"
        argv = ["stereo", "--data", str(data), "--model", name, "--crop",
                f"{crop[0]}x{crop[1]}", "--batch", str(batch), "--dtype",
                "bfloat16", "--lr", "1e-3", "--warmup", "5", "--ckpt-dir",
                str(ck), "--out", str(out), *dev]
        zero_counts(counters)
        recs, secs = run_app(train_app, argv + ["--steps", str(steps)])
        counts = read_counts(counters)
        losses = [r["loss"] for r in recs if "loss" in r]
        check(losses and all(np.isfinite(losses)),
              f"9c {name}: losses {losses}")
        fwd, bwd = (counts[k] for k in kernels)
        print(f"9c train_app stereo {name} {crop[0]}x{crop[1]} b{batch} bf16 "
              f"{steps} steps in {secs:.1f} s (data, eval and checkpoint "
              f"included): logged losses {losses}; launches {kernels[0]} "
              f"{fwd} (forward, its remat recompute, the final eval), "
              f"{kernels[1]} {bwd}; all counts {counts}")
        if card == "cuda":
            check(bwd == steps and fwd >= 2 * steps,
                  f"9c {name}: {kernels[1]} {bwd}, {kernels[0]} {fwd} in "
                  f"{steps} steps")
        for k in kernels:
            by_path.setdefault(k, {})[f"9c {name} train"] = counts[k]
        # the volume layouts' backward: no path of the port differentiates
        # the `dlast` / `hdw` volumes, so its count is kept and must read 0
        dense = counts["corr_cost_volume_bwd"]
        check(dense == 0, f"9c {name}: corr_cost_volume_bwd launched "
              f"{dense} times")
        by_path.setdefault("corr_cost_volume_bwd", {})[
            f"9c {name} train"] = dense

        # the loss on one fixed batch, init params against trained
        cfg = tstereo.StereoTrainConfig(model=name, crop_hw=crop,
                                        batch_size=batch, dtype="bfloat16")
        spec = tstereo._make_spec(cfg)
        init_fn, step_fn = ptrain.make_train_step(
            spec, tstereo._make_optimizer(cfg), compute_dtype=torch.bfloat16,
            device=card)
        fixed = next(kitti.KittiStereoDataset(data).batches(
            batch, crop, shuffle=False))
        before_after = []
        for tree in (models.init_stereo_params(spec, seed=cfg.seed),
                     models.params_from_npz(out)):
            with torch.no_grad():
                loss, _ = ptrain.stereo_loss(spec, init_fn(tree).params,
                                             *fixed, remat=False)
            before_after.append(float(loss))
        check(before_after[1] < before_after[0],
              f"9c {name}: loss on a fixed batch {before_after[0]} -> "
              f"{before_after[1]}, no fall")
        print(f"9c {name}: loss on a fixed batch, init {before_after[0]:.5f}"
              f" -> trained {before_after[1]:.5f}")

        # resume 2 more steps from the checkpoint
        zero_counts(counters)
        recs, _ = run_app(train_app, argv + ["--steps", str(steps + 2),
                                             "--resume"])
        counts = read_counts(counters)
        check([r["step"] for r in recs if "loss" in r] == [steps + 2],
              f"9c {name} --resume: logged {recs}")
        if card == "cuda":
            check(counts[kernels[1]] == 2,
                  f"9c {name} --resume: {counts[kernels[1]]} backwards")

        # the trained params served
        node = nodes.StereoNode(spec, models.params_from_npz(out),
                                dtype=torch.bfloat16, device=card)
        img = (fixed[0][0] * 255).astype(np.uint8)
        disp = node(img, (fixed[1][0] * 255).astype(np.uint8))
        check(disp.shape == crop and np.isfinite(disp).all(),
              f"9c {name}: served {disp.shape}, finite "
              f"{np.isfinite(disp).all()}")

        # step time, busy, idle, peak memory: the app's step on one batch
        figures[name] = {"loss_fixed_batch": before_after}
        if card == "cuda":
            state = init_fn(models.init_stereo_params(spec, seed=cfg.seed))
            figures[name].update(time_train_steps(
                torch, lambda: step_fn(state, *fixed),
                f"{name} train step {crop[0]}x{crop[1]} b{batch} bf16"))

    # TrailNet: no kernel of the port on its path
    trails = write_trails(np, root / "trails")
    out, prefix = root / "trailnet.npz", root / "trailnet_caffe" / "trail"
    zero_counts(counters)
    t_batch = 16 if card == "cuda" else 2
    recs, secs = run_app(train_app, [
        "trailnet", "--data", str(trails), "--batch", str(t_batch),
        "--steps", str(steps), "--lr", "1e-3", "--warmup", "5", "--out",
        str(out), "--export-caffe", str(prefix), *dev])
    counts = read_counts(counters)
    check(not any(counts.values()), f"9c trailnet launched a kernel: "
          f"{counts}")
    tree = ckpt.load_params(out)
    from redtail_tpu_torch.data.trails import TrailsDataset, build_trail_lists
    images, labels = next(TrailsDataset(build_trail_lists(trails)["train"],
                                        seed=0).batches(t_batch))
    lab = torch.as_tensor(labels).long().to(card)
    before_after = []
    for params in (models.init_trailnet_params(0), tree):
        net = models.trailnet.params_from_numpy(params, device=card)
        with torch.no_grad():
            loss, _ = ttrail.trailnet_loss(net, torch.as_tensor(images).to(
                card), lab, lab)
        before_after.append(float(loss))
    check(np.isfinite(before_after).all() and before_after[1]
          < before_after[0], f"9c trailnet: loss {before_after}")
    probs = nodes.TrailNetNode(models.trailnet.params_from_numpy(
        tree, device=card), device=card)(images[0].astype(np.uint8))
    check(probs.shape == (6,) and np.allclose(
        [probs[:3].sum(), probs[3:].sum()], 1.0, atol=1e-3),
        f"9c trailnet served {probs}")
    print(f"9c train_app trailnet 180x320 b{t_batch} {steps} steps in "
          f"{secs:.1f} s: losses {[r['loss'] for r in recs if 'loss' in r]};"
          f" loss on a fixed batch {before_after[0]:.5f} -> "
          f"{before_after[1]:.5f}; kernel counts {counts}; served {probs}")
    figures["trailnet"] = {"loss_fixed_batch": before_after}
    if card == "cuda":
        init_fn, step_fn = ttrail.make_trailnet_train_step(device=card)
        state = init_fn(models.init_trailnet_params(0))
        gen = torch.Generator().manual_seed(1)
        figures["trailnet"].update(time_train_steps(
            torch, lambda: step_fn(state, gen, images, labels, labels),
            f"trailnet train step 180x320 b{t_batch} fp32"))
    return by_path, figures


# ----------------------------------------------------------------- phase 10

ENGINE_CHILD = "--engine-child"  # chip_smoke runs itself so for 10b
APP_CHILD = "--app-child"  # and so for 10b's builds
# The engines of 10b: (label, model, (H, W), dtype, head, quantize,
# weights: "conditioned" random or the repo's "real" NVSmall weights, the
# kernel counters its run must move)
ENGINES = (
    ("resnet18_2d", "resnet18_2d", FULL_HW, "bf16", "default", None,
     "conditioned", ("corr_softargmax",)),
    ("nvsmall fused", "nvsmall", FULL_HW, "bf16", "default", None, "real",
     ("fused_cv_emit",)),
    ("nvsmall packed", "nvsmall", FULL_HW, "bf16", "packed", None, "real",
     ("fused_cv_emit.packed", "conv223")),
    ("nvtiny plain", "nvtiny", SLICE_3D_HW, "fp32", "plain", None,
     "conditioned", ("cost_volume_concat",)),
    ("resnet18_2d int8", "resnet18_2d", (129, 257), "bf16", "default",
     "int8", "conditioned", ("corr_softargmax",)),
)
# 10b, an engine's disparity against the eager model's on the same pair:
# fp32 (TF32 off on both sides) max abs, px; bf16 3D mean and max px (the
# packed head's gates of 5d); bf16 ResNet18-2D mean, sigmoid units (the
# bf16 slice gate of phase 4)
ENGINE_FP32_ATOL = 1e-4
ENGINE_2D_BF16_MEAN = 1e-2
# counter -> the kernels line's entry
COUNTER_ENTRY = {"corr_softargmax": "corr_cost_volume",
                 "cost_volume_concat": "cost_volume_concat",
                 "fused_cv_emit": "fused_cv_emit",
                 "fused_cv_emit.packed": "fused_cv_emit",
                 "conv223": "conv223"}


def write_pair(np, hw, tag, seed):
    """A random-texture uint8 BGR pair at ``hw`` as lossless PNGs under
    `SMOKE_DIR`; returns (frames, left path, right path)."""
    import cv2

    rng = np.random.default_rng(seed)
    left = rng.integers(0, 256, tuple(hw) + (3,), dtype=np.uint8)
    frames = (left, np.roll(left, -5, axis=1))
    paths = []
    for side, frame in zip(("left", "right"), frames):
        path = SMOKE_DIR / f"{tag}_{side}.png"
        cv2.imwrite(str(path), frame)
        paths.append(str(path))
    return frames, paths[0], paths[1]


def smoke_weights(np, models, ckpt, model, hw, kind):
    """(npz path, tree): the repo's real NVSmall weights, or the model's
    seeded init conditioned as phase 4 conditions it, written with
    `save_params`."""
    if kind == "real":
        path = ROOT / NVSMALL_NPZ
        return str(path), models.params_from_npz(path)
    spec = dataclasses.replace(models.STEREO_SPECS[model], input_hw=hw)
    tree = conditioned_params(np, models.init_stereo_params(spec, seed=1), 2)
    path = SMOKE_DIR / f"{model}_conditioned.npz"
    ckpt.save_params(tree, path)
    return str(path), tree


def run_stereo_app(stereo_app, argv, context):
    """`stereo_app.main(argv)` in this process under ``context``; returns
    its stderr (the layer table), its stdout dropped."""
    out, err = stdio.StringIO(), stdio.StringIO()
    with context(), contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(err):
        stereo_app.main(argv)
    return err.getvalue()


def phase_profile(np, torch, models, ckpt, stereo_app, counters,
                  packed3d_lowering, card="cuda"):
    """10a: `stereo_app --profile-layers` in this process: ResNet18-2D bf16
    at the full width (conditioned random weights; s2d frames, as the app
    profiles the serving form) and NVSmall bf16 with the repo's real
    weights under the packed head, each driven with every launch count
    set to 0 just before and read just after. The plan check runs on the
    card (the app raises if it fails). Returns the launches by path."""
    name = nvidia_smi("name,power.limit") if card == "cuda" else "cpu"
    paths = {}
    for label, model, kind, context, rows in (
            ("resnet18_2d", "resnet18_2d", "conditioned",
             contextlib.nullcontext, {"corr_cost_volume+softargmax":
                                      ("corr_softargmax",)}),
            ("nvsmall packed", "nvsmall", "real", packed3d_lowering,
             {"cost_volume+conv3D_1[pk]": ("fused_cv_emit.packed",),
              "conv3D_2[pk]": ("conv223",)})):
        weights, _ = smoke_weights(np, models, ckpt, model, FULL_HW, kind)
        _, left, right = write_pair(np, FULL_HW, f"profile_{model}", 10)
        argv = [model, "--weights", weights, "--dtype", "bf16", "--hw",
                *map(str, FULL_HW), "--left", left, "--right", right,
                "--out", str(SMOKE_DIR / f"profile_{model}"),
                "--profile-layers"] + (["--cpu"] if card == "cpu" else [])
        torch.cuda.synchronize()
        zero_counts(counters)
        t0 = time.perf_counter()
        err = run_stereo_app(stereo_app, argv, context)
        torch.cuda.synchronize()
        counts = read_counts(counters)
        table = [line for line in err.splitlines() if line.strip()]
        print(f"10a stereo_app {model} --dtype bf16 --hw {FULL_HW[0]} "
              f"{FULL_HW[1]} --profile-layers ({label}, "
              f"{time.perf_counter() - t0:.1f} s; {name}): launches {counts}")
        print("\n".join(table))
        # `format_layer_table`: the name in 34 columns, then the ms in 9
        summary = {line[:34].strip(): float(line[34:44]) for line in table
                   if line.startswith(("sum of layers", "end-to-end"))}
        print(f"10a {label}: {summary} ms ({name})")
        check(len(summary) == 2, f"10a {label}: no sum / e2e in the table")
        names = {line.split()[0] for line in table}
        for row, kernels in rows.items():
            check(row in names, f"10a {label}: no row {row} in the table")
            for kernel in kernels:
                check(counts[kernel] > 0, f"10a {label}: row {row} did not "
                      f"launch {kernel}: {counts}")
                paths.setdefault(COUNTER_ENTRY[kernel], {})[
                    f"10a {label} profile"] = counts[kernel]
    return paths


def synced_ms(torch, fn, args, reps=20):
    """Median host ms of one call that ends in a sync, after 3 warm-up
    calls: what a caller waits for a frame."""
    for _ in range(3):
        fn(*args)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def engine_child(payload):
    """10b, a fresh process (`ENGINE_CHILD`), one of five at once:
    `stereo_app --engine`'s flow (`stereo_app.run_engine`: load the engine,
    run it on the pair, write the disparity) with every launch count set to
    0 just before and read just after; then, once every engine process is
    ready and one at a time (a lock file), the engine's device time a
    frame (`layer_profiler.device_time_fn`) and its synced host time a
    call. Checks that no model module was imported; prints one JSON line
    last."""
    import fcntl

    import torch

    from redtail_tpu_torch.apps import stereo_app
    from redtail_tpu_torch.kernels import conv223 as c223
    from redtail_tpu_torch.kernels import corr_cost_volume as corr
    from redtail_tpu_torch.kernels import cost_volume_concat as concat
    from redtail_tpu_torch.kernels import fused_cv_emit as emit
    from redtail_tpu_torch.runtime import StageProfiler
    from redtail_tpu_torch.runtime.layer_profiler import device_time_fn

    counters = (corr.corr_cost_volume, corr.corr_softargmax,
                concat.cost_volume_concat, emit.fused_cv_emit, c223.conv223)
    device = torch.device(payload["device"])
    args = stereo_app.build_argparser().parse_args(
        [payload["model"], "--engine", payload["engine"], "--left",
         payload["left"], "--right", payload["right"], "--out",
         payload["out"], "--no-cache"])
    prof = StageProfiler()
    zero_counts(counters)
    call, inputs = stereo_app.run_engine(args, device, prof)
    torch.cuda.synchronize()
    counts = read_counts(counters)
    barrier = Path(payload["barrier"])
    (barrier / f"{payload['tag']}.ready").touch()
    deadline = time.monotonic() + 600
    while len(list(barrier.glob("*.ready"))) < payload["count"]:
        check(time.monotonic() < deadline, "10b: the other engine processes "
              "never became ready")
        time.sleep(0.2)
    with open(barrier / "timing.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)   # the card to this process alone
        device_ms = 1e3 * device_time_fn(call, inputs)
        call_ms = synced_ms(torch, call, inputs)
    models = sorted(m for m in sys.modules
                    if m.startswith("redtail_tpu_torch.models"))
    stats = prof.stats()
    print(json.dumps({"load_ms": stats["load_engine"]["mean_ms"],
                      "first_call_ms": stats["execute"]["mean_ms"],
                      "launches": counts, "device_ms": device_ms,
                      "host_ms": call_ms, "models": models}))


def argparse_namespace(payload):
    import argparse

    return argparse.Namespace(left=payload["left"], right=payload["right"])


def app_child(payload, stereo_app, heads):
    """10b, a process of its own (`APP_CHILD`): `stereo_app.main` under the
    engine's head (a context variable, so it cannot cross a process
    boundary as an argument would); the app's stderr passes through."""
    with heads[payload["head"]]():
        stereo_app.main(payload["argv"])


def usable_cores() -> int:
    import os

    return len(os.sched_getaffinity(0))


def phase_engines(np, torch, models, nodes, ckpt, stereo_app, plain_lowering,
                  packed3d_lowering, card="cuda"):
    """10b: every engine of `ENGINES` built with `stereo_app --save-engine`
    (the pristine builder), the five apps at once, each in a process of its
    own (`APP_CHILD`); then each run by a fresh process with `--engine`
    (`engine_child`, the five at once, timed one at a time), its launches
    counted there; then, here, its disparity held against the eager
    model's on the same pair:
    `StereoNode`, or for the int8 rung (which the app calibrates on the pair
    in its dtype, the node in fp32) the app's own quantized net. Returns the
    launches by path and the figures."""
    import os

    from redtail_tpu_torch.io import read_bin
    from redtail_tpu_torch.runtime.cache import read_sidecar
    from redtail_tpu_torch.runtime.layer_profiler import device_time_fn

    heads = {"default": contextlib.nullcontext, "plain": plain_lowering,
             "packed": packed3d_lowering}
    name = nvidia_smi("name,power.limit") if card == "cuda" else "cpu"
    env = dict(os.environ)
    # the builds share this machine's cores
    env["TORCHINDUCTOR_COMPILE_THREADS"] = str(
        max(1, usable_cores() // len(ENGINES)))
    builds = []
    t0 = time.perf_counter()
    for label, model, hw, dtype, head, quantize, kind, _ in ENGINES:
        tag = label.replace(" ", "_")
        weights, tree = smoke_weights(np, models, ckpt, model, hw, kind)
        frames, left, right = write_pair(np, hw, f"engine_{tag}", 11)
        engine = SMOKE_DIR / f"{tag}.pt2"
        argv = [model, "--weights", weights, "--dtype", dtype, "--hw",
                *map(str, hw), "--left", left, "--right", right, "--out",
                str(SMOKE_DIR / f"{tag}_eager"), "--save-engine",
                str(engine)] + (
                    ["--quantize", quantize] if quantize else []) + (
                    ["--cpu"] if card == "cpu" else [])
        proc = subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), APP_CHILD,
             json.dumps({"head": head, "argv": argv})], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        builds.append((proc, tree, frames, left, right, engine))
    outputs = [proc.communicate(timeout=900) for proc, *_ in builds]
    print(f"10b: {len(ENGINES)} engines built at once in "
          f"{time.perf_counter() - t0:.1f} s ({usable_cores()} cores, "
          f"{env['TORCHINDUCTOR_COMPILE_THREADS']} compile thread(s) each)")

    barrier = SMOKE_DIR / "engine_barrier"
    shutil.rmtree(barrier, ignore_errors=True)
    barrier.mkdir(parents=True)
    runs = []
    t0 = time.perf_counter()
    for spec_row, build, (_, err) in zip(ENGINES, builds, outputs):
        label, model = spec_row[:2]
        proc, engine = build[0], build[5]
        check(proc.returncode == 0, f"10b {label}: stereo_app --save-engine "
              f"exited {proc.returncode}:\n{err[-3000:]}")
        tag = label.replace(" ", "_")
        payload = {"model": model, "engine": str(engine), "left": build[3],
                   "right": build[4], "out": str(SMOKE_DIR / f"{tag}_engine"),
                   "device": card, "barrier": str(barrier), "tag": tag,
                   "count": len(ENGINES)}
        runs.append((payload, subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), ENGINE_CHILD,
             json.dumps(payload)], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, cwd=ROOT)))
    reports = [child.communicate(timeout=900) for _, child in runs]
    print(f"10b: {len(ENGINES)} fresh engine processes at once, "
          f"{time.perf_counter() - t0:.1f} s")

    paths, figures = {}, {}
    for spec_row, build, (_, err), (payload, child), (out, child_err) in zip(
            ENGINES, builds, outputs, runs, reports):
        label, model, hw, dtype, head, quantize, kind, kernels = spec_row
        proc, tree, frames, left, right, engine = build
        summary = next(line for line in err.splitlines()
                       if line.startswith("engine written to"))
        meta = read_sidecar(engine)
        tag = payload["tag"]
        check(child.returncode == 0, f"10b {label}: the engine process "
              f"exited {child.returncode}:\n{child_err[-3000:]}")
        report = json.loads(out.strip().splitlines()[-1])
        check(report["models"] == [], f"10b {label}: the engine process "
              f"imported {report['models']}")
        for kernel in kernels:
            check(report["launches"][kernel] >= 1, f"10b {label}: the engine "
                  f"did not launch {kernel}: {report['launches']}")
            paths.setdefault(COUNTER_ENTRY[kernel], {})[
                f"10b {label} engine"] = report["launches"][kernel]

        # the eager model on the same pair
        spec = dataclasses.replace(models.STEREO_SPECS[model], input_hw=hw)
        tdtype = torch.bfloat16 if dtype == "bf16" else torch.float32
        got = read_bin(SMOKE_DIR / f"{tag}_engine.bin")
        pair = stereo_app.read_pair(argparse_namespace(payload), *hw, tdtype)
        with heads[head](), torch.inference_mode():
            if quantize == "int8":
                net = stereo_app.quantized_net(spec, tree, quantize, tdtype,
                                               card, *pair)
                inputs = tuple(torch.from_numpy(a).to(card, tdtype)
                               for a in pair)
                want = net(*inputs).float().cpu().numpy()[0]
            else:
                node = nodes.StereoNode(spec, tree, dtype=tdtype,
                                        device=card)
                net = node.net
                want = node(*frames) / (hw[1] if spec.corr else 1.0)
                inputs = tuple(
                    torch.from_numpy(f).to(card, tdtype) for f in
                    stereo_app.serving_frames(*pair, s2d=True))
            eager_ms = 1e3 * device_time_fn(net, inputs)
            eager_host_ms = synced_ms(torch, net, inputs)
        err_map = np.abs(got - want)
        unit = "" if spec.corr else " px"
        print(f"10b {label} ({model} {hw[0]}x{hw[1]} {dtype}, head {head}, "
              f"{quantize or 'no'} quantization; {name}): {summary}; package "
              f"{engine.stat().st_size / 2**20:.1f} MiB; fresh process: load "
              f"{report['load_ms']:.0f} ms, first call "
              f"{report['first_call_ms']:.0f} ms; launches "
              f"{report['launches']}; device time a frame: engine "
              f"{report['device_ms']:.4f} ms, eager {eager_ms:.4f} ms; "
              f"synced host time a call: engine {report['host_ms']:.3f} ms, "
              f"eager {eager_host_ms:.3f} ms; engine vs eager mean "
              f"{err_map.mean():.3e}{unit}, max {err_map.max():.3e}{unit}")
        check(got.shape == tuple(hw) and np.isfinite(got).all(),
              f"10b {label}: engine disparity {got.shape} not finite/shaped")
        if dtype == "fp32":
            check(err_map.max() <= ENGINE_FP32_ATOL, f"10b {label}: fp32 "
                  f"engine off eager by {err_map.max()}")
        elif spec.corr:
            check(err_map.mean() < ENGINE_2D_BF16_MEAN, f"10b {label}: bf16 "
                  f"engine off eager by mean {err_map.mean()}")
        else:
            check(err_map.mean() < PACKED_MEAN and err_map.max() < PACKED_MAX,
                  f"10b {label}: bf16 engine off eager by mean "
                  f"{err_map.mean()}, max {err_map.max()}")
        figures[label] = {"export_s": meta["export_s"],
                          "compile_s": meta["compile_s"],
                          "package_mib": engine.stat().st_size / 2 ** 20,
                          "load_ms": report["load_ms"],
                          "first_call_ms": report["first_call_ms"],
                          "engine_ms": report["device_ms"],
                          "eager_ms": eager_ms,
                          "engine_host_ms": report["host_ms"],
                          "eager_host_ms": eager_host_ms,
                          "err_mean": float(err_map.mean()),
                          "err_max": float(err_map.max())}
    print(f"10b engine figures ({name}): {json.dumps(figures)}")
    return paths, figures


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: this "
                           "smoke test needs an NVIDIA card")
    sys.path.insert(0, str(ROOT))
    if sys.argv[1:2] == [ENGINE_CHILD]:  # before any model import
        engine_child(json.loads(sys.argv[2]))
        return 0
    if sys.argv[1:2] == [APP_CHILD]:
        from redtail_tpu_torch.apps import stereo_app
        from redtail_tpu_torch.ops.convolution import (packed3d_lowering,
                                                       plain_lowering)
        app_child(json.loads(sys.argv[2]), stereo_app,
                  {"default": contextlib.nullcontext, "plain": plain_lowering,
                   "packed": packed3d_lowering})
        return 0
    try:
        from redtail_tpu_torch import (io, kernels, models, native,
                                       seeded_generator)
        from redtail_tpu_torch.kernels import corr_cost_volume as corr
        from redtail_tpu_torch.kernels import cost_volume_concat as concat
        from redtail_tpu_torch.kernels import conv223 as c223
        from redtail_tpu_torch.kernels import fused_cv_emit as emit
        from redtail_tpu_torch.models import trailnet
        from redtail_tpu_torch.ops import convolution as conv
        from redtail_tpu_torch.ops.convolution import (packed3d_lowering,
                                                       plain_lowering)
        from redtail_tpu_torch.quant import ptq, stereo_int8
        from redtail_tpu_torch.ops.softargmax import softargmax
        from redtail_tpu_torch.ops.space_to_depth import space_to_depth2_np
        from redtail_tpu_torch.runtime import nodes
        from redtail_tpu_torch.apps import stereo_app, train_app
        from redtail_tpu_torch.data import kitti
        from redtail_tpu_torch.parallel import training as ptrain
        from redtail_tpu_torch.training import stereo as tstereo
        from redtail_tpu_torch.training import trailnet as ttrail
        from redtail_tpu_torch.utils import checkpoint as ckpt
    except ImportError as e:
        raise SmokeFailure(f"redtail_tpu_torch is not beside chip_smoke.py "
                           f"({e})") from e
    counters = (corr.corr_cost_volume, corr.corr_softargmax,
                concat.cost_volume_concat, emit.fused_cv_emit, c223.conv223)
    if sys.argv[1:] == [OVERLAP_CHILD]:
        overlap_child(np, torch, models, nodes, counters)
        return 0
    if sys.argv[1:] == [RUNGS_CHILD]:
        rungs_child(np, torch, models, nodes, counters, packed3d_lowering)
        return 0

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
                if "Compiling entry" in line:
                    print(f"  {name}: {line.split(chr(39))[1][:90]}")
                elif any(key in line for key in ("registers", "spill",
                                                 "C7520", "C7508")):
                    print(f"  {name}: {line.strip()[:160]}")

    gen = seeded_generator(0)
    entries = {"corr_cost_volume": phase_corr(torch, corr, softargmax, gen),
               "cost_volume_concat": phase_concat(torch, concat, gen),
               "fused_cv_emit": phase_emit(torch, emit, gen),
               "conv223": phase_conv223(torch, c223, gen)}
    phase_slice(np, torch, models, space_to_depth2_np,
                {"fused": contextlib.nullcontext, "plain": plain_lowering,
                 "packed": packed3d_lowering})
    fused, volume = phase_serve_2d(np, torch, models, nodes, counters)
    by_path = {"corr_cost_volume": {"5a resnet18_2d": fused}}
    for mode in entries["corr_cost_volume"]["modes"]:
        # the volume's counter counts both its layouts
        mode["launches"] = fused if mode["mode"] == "softargmax" else volume
    by_path.update(phase_serve_3d(np, torch, models, nodes, counters,
                                  plain_lowering, packed3d_lowering))

    # TrailNet and YOLO run no kernel of the port: the counters stay put
    before = read_counts(counters)
    print_counts(counters, "before the TrailNet and YOLO phases")
    phase_trailnet(np, torch, io, models, trailnet, nodes)
    phase_yolo(np, torch, io, models, nodes)
    print_counts(counters, "after the TrailNet and YOLO phases")
    check(read_counts(counters) == before,
          f"a kernel launched on the TrailNet / YOLO path: {before} -> "
          f"{read_counts(counters)}")

    # the serving runtime
    phase_native(np, native, space_to_depth2_np)
    frames2d, ref2d, params2d, paths = phase_overlap(np, torch, models,
                                                     nodes)
    by_path["corr_cost_volume"].update(paths)
    for name, paths in phase_microbatch(
            np, torch, models, nodes, counters, packed3d_lowering,
            frames2d, ref2d, params2d).items():
        by_path[name].update(paths)
    by_path["corr_cost_volume"].update(phase_u16(
        np, torch, models, nodes, counters, frames2d, ref2d, params2d))
    paths, _ = phase_pipeline(np, models, native, counters)
    by_path["corr_cost_volume"].update(paths)
    phase_sim(counters)

    # real weights in, quantized rungs out
    frame = stereo_frames(np, 8, 1)[0]  # 8b's first pair
    blobs, golden = phase_blob(np, torch, io, models, nodes, frame)
    figures = phase_rungs(np)
    for name, f in figures.items():
        model = name.split(" bf16 ")[0]
        for kernel, entry in (("corr_softargmax", "corr_cost_volume"),
                              ("fused_cv_emit", "fused_cv_emit"),
                              ("fused_cv_emit.packed", "fused_cv_emit"),
                              ("conv223", "conv223")):
            if kernel in RUNG_KERNELS[model]:
                by_path[entry][f"8b {name}"] = f["launches"][kernel]
    phase_quant_card_vs_cpu(np, torch, models, ptq, stereo_int8, conv, c223,
                            emit)
    phase_int8_routes(np, torch, models, nodes, ptq)
    phase_app(np, blobs["fp16"], golden, frame)
    print_repair_cost(figures)

    # training: the backward kernels, a step card vs CPU, the main path
    entries["corr_bwd"] = phase_corr_bwd(torch, corr, gen)
    entries["concat_bwd"] = phase_concat_bwd(torch, concat, gen)
    all_counters = counters + (corr.corr_cost_volume_bwd,
                               corr.corr_softargmax_bwd,
                               concat.cost_volume_concat_bwd)
    phase_train_slice(np, torch, models, ptrain, all_counters)
    train_paths, train_figures = phase_train_main(
        np, torch, models, ptrain, tstereo, ttrail, train_app, kitti, nodes,
        ckpt, all_counters)
    for counter, entry in (("corr_softargmax", "corr_cost_volume"),
                           ("cost_volume_concat", "cost_volume_concat"),
                           ("corr_softargmax_bwd", "corr_bwd"),
                           ("cost_volume_concat_bwd", "concat_bwd")):
        by_path.setdefault(entry, {}).update(train_paths[counter])
    print(f"9c train figures ({nvidia_smi('name,power.limit')}): "
          f"{json.dumps(train_figures)}")

    # layer profiling and serialized engines
    for entry, paths in phase_profile(np, torch, models, ckpt, stereo_app,
                                      counters, packed3d_lowering).items():
        by_path[entry].update(paths)
    engine_paths, _ = phase_engines(np, torch, models, nodes, ckpt,
                                    stereo_app, plain_lowering,
                                    packed3d_lowering)
    for entry, paths in engine_paths.items():
        by_path[entry].update(paths)

    for name, paths in by_path.items():
        check(all(paths.values()), f"{name} was not launched on {paths}")
        entries[name]["launches"] = sum(paths.values())
        entries[name]["launches_by_path"] = paths
    entries["corr_cost_volume"]["modes"][0]["launches"] = \
        entries["corr_cost_volume"]["launches"]
    for mode in entries["corr_bwd"]["modes"]:
        # the layouts' backward counts on its own counter, read in 9c
        dense = train_paths["corr_cost_volume_bwd"]
        if mode["mode"] == "softargmax":
            mode["launches"] = entries["corr_bwd"]["launches"]
        else:
            mode["launches"] = sum(dense.values())
            mode["launches_by_path"] = dense

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
