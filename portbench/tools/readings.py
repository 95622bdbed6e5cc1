"""The readings the check's limits are set from (`limits/<cell>.json`):
the compared numbers of sound runs of the program over many seeds, of the
control (the program's own lower-precision path where it has one, else the
reference in fp8 put in its place) and of the faults a cell can have, all
through the cell's own timed path at its own size, with a short window.

    python3 portbench/tools/readings.py --workload nvsmall.serve \
        --seeds 12 --control-seeds 3 --seconds 3 [--out FILE]

Runs on the card (the benchmark's own runs never run it). Serving cells:
``program``, ``control.fp8`` (the reference's forward in fp8 in the
node's place: the whole path, the 3D stack too) and ``control.int8`` (the
program's int8 rung, calibrated on four pool pairs: its 2D towers only).
Training cells: ``program``, ``control.fp8`` (the fp8 reference as the
train step) and ``fault.half_batch`` (the program's step on half of each
batch). A state left unchanged reads 1 by the change's measure and needs
no run. A cell's limits name the controls it is held against
(``controls``).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SEED0 = 2 ** 31 + 7919


def reference_trainer(spec, config, traffic, tree, device):
    """The reference's train step in fp8 in the program's place."""
    from portbench.reference.stereo import Trainer
    return Trainer(config, tree, device, lr=config["train"]["lr"],
                   precision="fp8")


def half_batch_trainer(spec, config, traffic, tree, device):
    """The program's step with half of each batch left out: the mean taken
    over the rest."""
    from portbench.harness.port import PortTrainer

    class Half(PortTrainer):
        def step(self, batch):
            k = batch[0].shape[0] // 2
            return super().step(tuple(a[:k] for a in batch))
    return Half(spec, config, traffic, tree, device)


class ReferenceNode:
    """The reference's forward in fp8 in the serving node's place: a uint8
    BGR pair in, its disparity on the host out, in the same call."""

    def __init__(self, config, tree, device):
        from portbench.reference import stereo as ref
        self.ref, self.config, self.device = ref, config, device
        self.p = ref.to_torch(tree, config, device)

    def warmup(self, left, right):
        self(left, right)

    def drain(self):
        return None

    def __call__(self, left, right):
        import torch
        ref = self.ref
        pair = [ref.frames_to_rgb(torch.from_numpy(x[None]).to(self.device))
                for x in (left, right)]
        with torch.no_grad():
            disp = ref.forward(self.p, self.config, *pair, precision="fp8")
        return disp[0].cpu().numpy()


def fp8_node(spec, config, traffic, tree, device, *, frames=None):
    return ReferenceNode(config, tree, device)


def int8_node(spec, config, traffic, tree, device, *, frames=None):
    """The program's node on its int8 rung."""
    from portbench.harness.port import make_node
    return make_node(spec, dict(config, quantize="int8"), traffic, tree,
                     device, frames=frames)


def variants(cell, seed, device):
    """(label, hooks) of the runs a seed gets besides the program's."""
    if cell.traffic["kind"] == "train_steps":
        return [("control.fp8", {"trainer": reference_trainer}),
                ("fault.half_batch", {"trainer": half_batch_trainer})]
    return [("control.fp8", {"node": fp8_node}),
            ("control.int8", {"node": int8_node})]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--first-seed", type=int, default=SEED0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("readings.py runs on an NVIDIA card")
    from portbench.harness import cell as C
    cell = C.load_cell(args.workload)
    rows = []
    for i in range(args.seeds):
        seed = args.first_seed + 1009 * i
        runs = [("program", {})]
        if i < args.control_seeds:
            runs += variants(cell, seed, "cuda")
        for label, hooks in runs:
            r = C.run_cell(cell, seed, args.seconds, False, device="cuda",
                           hooks=hooks)
            row = {"label": label, "seed": seed, "numbers": r["numbers"],
                   "correct": r["correct"], "attempted": r["attempted"],
                   "notes": r["notes"]}
            rows.append(row)
            print(json.dumps(row), flush=True)
    labels = sorted({r["label"] for r in rows})
    names = sorted(rows[0]["numbers"])
    for label in labels:
        for name in names:
            vals = [r["numbers"][name] for r in rows if r["label"] == label]
            print(f"{args.workload} {label} {name}: min {min(vals)!r} max "
                  f"{max(vals)!r} over {len(vals)} seeds")
    if args.out:
        Path(args.out).write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
