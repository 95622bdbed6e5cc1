"""A stream of stereo pairs through the serving node (`traffic/<name>.json`
of kind ``stream``): the pool of uint8 pairs made from the seed, the node
set up and warmed on the cell's own frames, the window (`harness/
traffic.py:stream`, closed loop or at a fixed rate), and the check of a
seeded sample of the frames the window completed against the reference's
forward of the same pairs."""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from portbench.harness import cell as C
from portbench.harness import check, data, port, traffic
from portbench.reference import stereo as reference


def inputs(config: dict, tr: dict, g: torch.Generator, device):
    return data.make_frames(config, tr, g, device)


def drive(cell, spec, tree, frames, seed: int, seconds: float,
          traced: bool, device, t_start: float, regions, hooks,
          out) -> None:
    config, tr = cell.config, cell.traffic
    left, right, _shifts = frames
    make = hooks.get("node", port.make_node)
    node = make(spec, config, tr, tree, device, frames=(left, right))
    out.mark("program built")
    with port.head_context(config):
        node.warmup(left[0], right[0])
        for i in range(tr["warmup_frames"]):
            node(left[i % len(left)], right[i % len(left)])
        node.drain()
        if hasattr(node, "profiler"):
            node.profiler.reset()
        C.sync(device)
        out.memory_peak_bytes = C.peak(device)
        C.reset_peak(device)
        out.mark("warmed")
        out.e2e["setup_s"] = time.perf_counter() - t_start
        rng = np.random.default_rng(int(seed) % data.SEED_MOD)
        with C.Window(traced, device) as win:
            w = traffic.stream(node, hooks.get("results", port.results),
                               left, right, seconds,
                               rate_hz=tr["rate_hz"],
                               keep=tr["checked_frames"], rng=rng)
        node.drain()
    C.sync(device)
    peak = C.peak(device)
    out.memory_peak_bytes = max(out.memory_peak_bytes, peak)
    lat_ms = [1e3 * v for v in w.latencies]
    out.attempted = w.completed
    out.e2e["frames_per_s"] = w.completed / w.seconds
    out.e2e["frame_ms_p95"] = float(np.percentile(lat_ms, 95)) \
        if lat_ms else float("inf")
    out.notes.append(
        f"window {w.seconds:.4f} s: {w.submitted} frames submitted, "
        f"{w.completed} completed; latency ms median "
        f"{statistics.median(lat_ms) if lat_ms else float('nan'):.4f}, "
        f"p95 {out.e2e['frame_ms_p95']:.4f} over {len(lat_ms)} samples "
        f"({max(0, len(lat_ms) - int(0.95 * len(lat_ms)))} beyond it)")
    stages = port.stage_means_ms(node) if hasattr(node, "profiler") else {}
    out.run = C.Run(cell, tr["kind"], w.seconds, w.completed, 1,
                    tuple(config["input_hw"]), 1, stages,
                    win.summary(regions), peak)
    del node
    C.free(device)
    t = time.perf_counter()
    p = reference.to_torch(tree, config, device)
    pairs, cache = [], {}
    with torch.no_grad():
        for idx, got in w.kept:
            if idx not in cache:
                l_u8 = torch.from_numpy(left[idx:idx + 1]).to(device)
                r_u8 = torch.from_numpy(right[idx:idx + 1]).to(device)
                cache[idx] = reference.forward(
                    p, config, reference.frames_to_rgb(l_u8),
                    reference.frames_to_rgb(r_u8))[0].cpu().numpy()
            pairs.append((got, cache[idx]))
    out.numbers = check.serve_numbers(pairs)
    out.notes.append(f"reference: {len(cache)} pairs for {len(pairs)} "
                     f"sampled frames in {time.perf_counter() - t:.3f} s")
