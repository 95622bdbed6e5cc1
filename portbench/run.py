"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Needs an NVIDIA card (exits 2, with no result, where there is none or
fewer than the cell asks for). Makes weights and inputs from ``--seed`` on
the card, warms the cell's shapes, measures for ``--seconds``, checks what
the timed path produced against the plain reference, and prints as its
last line one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device`` (and with ``--trace 1`` a ``breakdown``), and
last ``checks``: each number compared with its limit. The same numbers
close standard error. Earlier lines carry the card, its power limit and
clocks, sample counts and timings.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "redtail_tpu")


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (`redtail_tpu_torch` is not `redtail_tpu`)."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)


def nvidia_smi() -> str:
    query = "name,power.limit,clocks.sm,clocks.max.sm,temperature.gpu"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return out.stdout.strip().replace("\n", " | ")


def cell_chips(name: str) -> int:
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        if w["name"] == name:
            return int(w["chips"])
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def main(argv=None) -> int:
    args = parse(argv)
    chips = cell_chips(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} NVIDIA card(s); CUDA "
              f"available: {torch.cuda.is_available()}, cards: "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from portbench.harness import cell
    print(f"card: {nvidia_smi()} (name, power limit, SM clock, max SM "
          f"clock, temperature) before set-up", flush=True)
    result = cell.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), device="cuda", t_start=T_START)
    print(f"card: {nvidia_smi()} after the window", flush=True)
    for note in result["notes"]:
        print(f"portbench: {note}", flush=True)
    print(f"portbench: numbers {json.dumps(result['numbers'])}", flush=True)
    found = forbidden_modules()
    if found:
        print(f"portbench: JAX or the JAX package is loaded: {found}",
              file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": result["memory_peak_bytes"]}
    line = {"correct": result["correct"], "attempted": result["attempted"],
            "failed": result["failed"], "metrics": result["metrics"],
            "device": device}
    if args.trace:
        device["busy_s"] = result["busy_s"]
        device["window_s"] = result["window_s"]
        line["breakdown"] = result["breakdown"]
    line["checks"] = result["checks"]
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
