"""Per-layer cost profiler for the stereo model zoo
(`redtail_tpu/runtime/layer_profiler.py`).

The reference printed a per-layer ms table from TensorRT's `IProfiler`
(`sample_app/main.cpp:52-81,302-312`). The port runs eagerly, one layer
after another, so a layer can be timed on the card as it runs in the
model: `stereo_layer_plan` runs `StereoNet`'s own forward
(`StereoNet.layers`) with a hook that records each layer as ``(name, fn,
args, out_shape)``, and `profile_stereo_layers` times each ``fn(*args)``
on its real input activations, on the device of those tensors.

Timing (`device_time_fn`): on the card, CUDA events around back-to-back
calls while the stream is held busy (`torch.cuda._sleep`) until the host
has enqueued them all, so the time is the device's alone (in windows of
as many calls as the card's launch queue takes); the median of a few
repetitions, with the JAX function's adaptive loop length for layers
under 0.5 ms. On the CPU, the host clock.

Because the plan is the forward itself, the per-layer sum is the eager
forward's device time less what lies between layers; both are reported.
The profiler still checks that the plan's composed output equals the
forward, as the JAX one does, so the table cannot drift from the model.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode


class LayerTime(NamedTuple):
    name: str
    ms: float
    out_shape: Tuple[int, ...]
    gflop: Optional[float] = None   # FlopCounterMode's count of the layer
    gbytes: Optional[float] = None  # the layer's input plus output bytes


class DevicePeaks(NamedTuple):
    tflops: float   # dense bf16 tensor-core TFLOP/s
    gbs: float      # HBM GB/s
    name: str       # the card's name, as CUDA reports it


# card name (lower case) substring -> (dense bf16 TFLOP/s, HBM GB/s), from
# NVIDIA's H100 data sheet; used only for the MFU / roofline columns.
# Matched in order, most specific first.
_GPU_PEAKS = (
    ("h100 pcie", (756.0, 2000.0)),
    ("h100 80gb hbm3", (989.0, 3350.0)),   # the SXM part
    ("h100 sxm", (989.0, 3350.0)),
)


def device_peaks(device) -> Optional[DevicePeaks]:
    """The peaks of the card ``device`` names, or None for the CPU or a
    card not in the table."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    for key, (tflops, gbs) in _GPU_PEAKS:
        if key in name.lower():
            return DevicePeaks(tflops, gbs, name)
    return None


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for a in tree for t in _tensors(a)]
    return []


def layer_cost_analysis(fn, args):
    """(GFLOP, GB) of ``fn(*args)``: the operations `FlopCounterMode`
    counts (convolutions, matrix products and the port's four kernels,
    whose counts are the ops' flop formulas, `kernels/_ops.py`; no
    elementwise work), and the bytes of the layer's tensor inputs and
    outputs, each read or written once: the isolated layer's least
    device-memory traffic (XLA's post-fusion byte count, which the JAX
    profiler reports, has no counterpart in eager PyTorch)."""
    with FlopCounterMode(display=False) as counter:
        out = fn(*args)
    nbytes = sum(t.numel() * t.element_size()
                 for t in _tensors(args) + _tensors(out))
    return counter.get_total_flops() / 1e9, nbytes / 1e9


def stereo_layer_plan(net, left, right):
    """Run ``net`` (a `StereoNet`) on the pair layer by layer, returning
    ``(entries, output)`` where ``entries`` is the ordered list of
    ``(name, fn, args, out_shape)``: running ``fn(*args)`` for each
    reproduces the forward (`StereoNet.layers`). The names follow the JAX
    plan's, with both towers as one batch (``towers_*`` for JAX's
    ``left_*`` and ``right_*``) and the corr volume and its soft-argmax as
    one kernel (``corr_cost_volume+softargmax``)."""
    entries: List[Tuple[str, Callable, tuple, Tuple[int, ...]]] = []

    def run(name, fn, *args):
        out = fn(*args)
        entries.append((name, fn, args, tuple(out.shape)))
        return out

    out = net.layers(left, right, run)
    return entries, out


# The stream hold ahead of each timed window (~2 ms at 1.98 GHz: idle
# device time each window costs), doubled up to 64x while the host takes
# longer to enqueue a window's calls.
HOLD_CYCLES = 4_000_000
MAX_HOLD_CYCLES = 64 * HOLD_CYCLES


def _device_of(args) -> torch.device:
    return next(t.device for t in _tensors(args))


def _window(fn, args, n, hold) -> Optional[float]:
    """Seconds of n back-to-back calls between CUDA events, the stream
    held until all n are enqueued; None where the hold ran out first (the
    host's enqueue would be in the window)."""
    torch.cuda._sleep(hold)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn(*args)
    end.record()
    stalled = start.query()
    end.synchronize()
    return None if stalled else start.elapsed_time(end) / 1e3


def _cuda_seconds(fn, args, n, reps) -> float:
    """Median over ``reps`` of the seconds a call, each rep n calls in
    held windows. The host blocks once the card's launch queue is full,
    which a held stream never drains, so a window whose hold ran out is
    taken again with half the calls and twice the hold."""
    per_window, hold, times = n, HOLD_CYCLES, []
    while len(times) < reps:
        total, calls = 0.0, 0
        while calls < n:
            w = min(per_window, n - calls)
            sec = _window(fn, args, w, hold)
            if sec is None:
                if per_window == 1 and hold == MAX_HOLD_CYCLES:
                    raise RuntimeError("device_time_fn: the host could not "
                                       "enqueue one call inside the hold")
                per_window = max(1, per_window // 2)
                hold = min(2 * hold, MAX_HOLD_CYCLES)
                continue
            total, calls = total + sec, calls + w
        times.append(total / calls)
    return statistics.median(times)


def _cpu_seconds(fn, args, n, reps) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(n):
            fn(*args)
        times.append((time.perf_counter() - t0) / n)
    return statistics.median(times)


def device_time_fn(fn, args, *, n_lo=5, n_hi=35, reps=3) -> float:
    """Seconds per call of ``fn(*args)`` on the device of ``args``' tensors
    (the caller's choice; nothing falls back): on the card, CUDA events
    around ``n_hi`` back-to-back calls with the stream held (see the module
    docstring), the median of ``reps``, after ``n_lo`` warm-up calls; on the
    CPU, the host clock the same way.

    Adaptive on the card, as the JAX function is: below 0.5 ms a call the
    loop is lengthened to ~60 ms of device time (at most 4000 calls), so a
    sub-0.1 ms layer is resolved against the events' resolution."""
    device = _device_of(args)
    for _ in range(n_lo):
        fn(*args)
    if device.type != "cuda":
        return _cpu_seconds(fn, args, n_hi, reps)
    with torch.cuda.device(device):
        est = _cuda_seconds(fn, args, n_hi, reps)
        if est < 0.5e-3:
            per = max(est, 2e-6)
            n = min(4000, max(n_hi * 2, int(0.06 / per)))
            est = _cuda_seconds(fn, args, n, reps)
    return est


def profile_stereo_layers(net, left, right, *, n_lo=5, n_hi=35, reps=3,
                          check=True):
    """Time every layer of ``net`` on the pair, on its real activations,
    under `torch.inference_mode()`.

    Returns ``(rows, e2e_seconds)``: rows are `LayerTime` in network order;
    ``e2e_seconds`` is the whole forward timed the same way. With
    ``check``, raises where the plan's composed output is off the forward
    by more than 1e-4 (fp32) or 1e-2 (bf16), as the JAX profiler does."""
    with torch.inference_mode():
        entries, out = stereo_layer_plan(net, left, right)
        if check:
            want = net(left, right)
            err = float((want.float() - out.float()).abs().max())
            tol = 1e-2 if net.dtype == torch.bfloat16 else 1e-4
            if not err <= tol:
                raise RuntimeError(f"layer plan diverged from the forward "
                                   f"(max err {err}, tol {tol})")
        rows = []
        for name, fn, args, out_shape in entries:
            sec = device_time_fn(fn, args, n_lo=n_lo, n_hi=n_hi, reps=reps)
            gflop, gbytes = layer_cost_analysis(fn, args)
            rows.append(LayerTime(name, sec * 1e3, out_shape, gflop, gbytes))
        e2e = device_time_fn(net, (left, right), n_lo=n_lo, n_hi=n_hi,
                             reps=reps)
    return rows, e2e


def format_layer_table(rows: List[LayerTime], e2e_seconds: float,
                       peaks: Optional[DevicePeaks] = None) -> str:
    """The reference's layer-time table (`main.cpp:52-81`), slowest first,
    with, where ``peaks`` is given (`device_peaks`), the JAX table's
    roofline columns: GFLOP, achieved TFLOP/s, MFU% (against the card's
    dense bf16 peak), GB moved and xRL, the time over the roofline bound
    max(flops / peak, bytes / bandwidth)."""
    total = sum(r.ms for r in rows)
    cols = peaks is not None and any(r.gflop is not None for r in rows)
    head = f"{'layer':<34s} {'ms':>9s} {'%':>6s}"
    if cols:
        head += (f" {'GFLOP':>8s} {'TFLOP/s':>8s} {'MFU%':>6s}"
                 f" {'GB':>7s} {'xRL':>6s}")
    lines = [head + "  output"]
    for r in sorted(rows, key=lambda r: -r.ms):
        line = f"{r.name:<34s} {r.ms:9.3f} {100 * r.ms / total:6.1f}"
        if cols:
            if r.gflop is not None and r.ms > 0:
                tflops = r.gflop / r.ms  # GFLOP/ms == TFLOP/s
                mfu = 100.0 * tflops / peaks.tflops
                roofline_ms = max(r.gflop / peaks.tflops,
                                  (r.gbytes or 0.0) / peaks.gbs)
                xrl = r.ms / roofline_ms if roofline_ms > 0 else float("inf")
                line += (f" {r.gflop:8.2f} {tflops:8.2f} {mfu:6.1f}"
                         f" {(r.gbytes or 0.0):7.3f} {xrl:6.1f}")
            else:
                line += f" {'-':>8s} {'-':>8s} {'-':>6s} {'-':>7s} {'-':>6s}"
        lines.append(line + f"  {r.out_shape}")
    lines.append(f"{'sum of layers':<34s} {total:9.3f}")
    if cols:
        gf = sum(r.gflop or 0.0 for r in rows)
        gb = sum(r.gbytes or 0.0 for r in rows)
        lines.append(
            f"{'totals':<34s} {gf:9.2f} GFLOP {gb:8.3f} GB; peaks "
            f"{peaks.tflops:.0f} TFLOP/s (bf16) / {peaks.gbs:.0f} GB/s "
            f"({peaks.name}, data sheet); xRL = time / max(compute, "
            "bandwidth) bound")
    lines.append(f"{'end-to-end (eager)':<34s} {e2e_seconds * 1e3:9.3f}"
                 "   (no cross-layer fusion: e2e ~ sum; the difference is "
                 "the work between layers, the host's launch gaps hidden "
                 "by the hold)")
    return "\n".join(lines)
