"""Train steps on batches made on the device (`traffic/<name>.json` of
kind ``train_steps``): one train-step object driven from the seed through
its first steps (read for the check), warmed, then the window (`harness/
traffic.py:train_steps`); the reference follows the first steps from the
same weights and batches."""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from portbench.harness import cell as C
from portbench.harness import check, data, port, traffic
from portbench.reference import stereo as reference

CHECKED_STEPS = 3
PASSES = 3  # a step's nominal work: the forward, input and weight grads


def inputs(config: dict, tr: dict, g: torch.Generator, device):
    return data.make_batches(config, tr, g, device)


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.detach().double()))
            for k, v in tensors.items()}


def drive(cell, spec, tree, batches, seed: int, seconds: float,
          traced: bool, device, t_start: float, regions, hooks,
          out) -> None:
    config, tr = cell.config, cell.traffic
    make = hooks.get("trainer", port.PortTrainer)
    trainer = make(spec, config, tr, tree, device)
    out.mark("program built")
    start = {k: v.detach().clone() for k, v in trainer.leaves().items()}
    losses = []
    for t in range(CHECKED_STEPS):
        losses.append(trainer.step(batches[t]))
        if t == 0:
            grad_norms = _norms(trainer.first_grads())
    change = _norms({k: v.detach() - start[k]
                     for k, v in trainer.leaves().items()})
    del start
    prog = {"losses": [float(v) for v in losses], "grad_norms": grad_norms,
            "change_norms": change}
    out.mark("checked steps")
    first = CHECKED_STEPS + tr["warmup_steps"]
    for t in range(CHECKED_STEPS, first):
        trainer.step(batches[t % len(batches)])
    C.sync(device)
    out.memory_peak_bytes = C.peak(device)
    C.reset_peak(device)
    out.mark("warmed")
    out.e2e["setup_s"] = time.perf_counter() - t_start
    with C.Window(traced, device) as win:
        w = traffic.train_steps(trainer.step, batches, seconds, first,
                                sync=lambda: C.sync(device))
    peak = C.peak(device)
    out.memory_peak_bytes = max(out.memory_peak_bytes, peak)
    out.attempted = w.steps
    out.e2e["train_step_ms"] = 1e3 * w.seconds / max(w.steps, 1)
    last = float(w.last_loss) if w.last_loss is not None else float("nan")
    out.notes.append(f"window {w.seconds:.4f} s: {w.steps} steps; checked "
                     f"losses {prog['losses']}; last window loss {last:.6g}")
    out.run = C.Run(cell, tr["kind"], w.seconds, w.steps, tr["batch"],
                    tuple(tr["crop"]), PASSES, {}, win.summary(regions),
                    peak)
    del trainer, w
    C.free(device)
    t = time.perf_counter()
    ref = hooks.get("reference", reference.train)(
        config, tree, batches[:CHECKED_STEPS], steps=CHECKED_STEPS,
        device=device, lr=config["train"]["lr"])
    out.numbers = check.train_numbers(prog, ref)
    if not np.isfinite(last):
        out.numbers["loss_gap"] = float("inf")
    gaps = [abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                 ref["losses"])]
    out.notes.append(f"reference: {CHECKED_STEPS} steps in "
                     f"{time.perf_counter() - t:.3f} s; losses "
                     f"{ref['losses']}; each step's loss gap {gaps}; worst "
                     f"leaves {check.worst_leaves(prog, ref)}")
