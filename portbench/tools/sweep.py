"""The highest frame rate a serving cell's node sustains: the cell's
traffic in an open loop at each given rate (and frames in flight), one
window each, on the card. A rate is sustained when the frames completed a
second match it and the latency does not grow across the window (the
last quarter's median against the first's).

    python3 portbench/tools/sweep.py --workload nvsmall.serve \
        --overlap 0 --rates 40 44 48 52 --seconds 10

Runs on the card (the benchmark's own runs never run it); a cell's
``rate_hz`` is set at about four fifths of the highest rate sustained.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SEED = 2 ** 31 + 104729


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--overlap", type=int)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("sweep.py runs on an NVIDIA card")
    from portbench.harness import cell as C
    from portbench.harness import traffic
    windows = []
    real = traffic.stream

    def keep(*a, **kw):
        windows.append(real(*a, **kw))
        return windows[-1]
    traffic.stream = keep
    for rate in args.rates:
        cell = C.load_cell(args.workload)
        cell.traffic["rate_hz"] = rate
        if args.overlap is not None:
            cell.traffic["overlap"] = args.overlap
        r = C.run_cell(cell, SEED, args.seconds, False, device="cuda")
        w = windows[-1]
        lat = [1e3 * v for v in w.latencies]
        q = len(lat) // 4
        row = {"rate_hz": rate, "overlap": cell.traffic["overlap"],
               "frames_per_s": w.completed / w.seconds,
               "frame_ms_p95": statistics.quantiles(lat, n=20)[-1],
               "median_ms_first_quarter": statistics.median(lat[:q]),
               "median_ms_last_quarter": statistics.median(lat[-q:]),
               "correct": r["correct"]}
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
