"""Small cells for the CPU tests: the published configurations at their
widths on frames and crops a CPU test can run, with the real cells'
traffic, limits and metric entries."""

from __future__ import annotations

import copy
import json

from portbench.harness.cell import ROOT, Cell, load_cell

SERVE_HW = (32, 96)
TRAIN = {"batch": 2, "crop": [16, 64], "pool": 4, "target_band": 2,
         "warmup_steps": 1}


def tiny_config(name: str) -> dict:
    """The configuration ``name`` at a test's size: its published widths,
    32x96 frames, max_disp 16."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    conf = {c["name"]: c for c in bench["configs"]}[name]
    config = json.loads((ROOT / conf["file"]).read_text())
    config.pop("port_spec")
    config["model"] = "tiny_" + config["model"]
    config["input_hw"] = list(SERVE_HW)
    config["max_disp"] = 16
    return config


def tiny_cell(name: str, **traffic) -> Cell:
    """The cell ``name`` with its configuration at a test's size, the
    training crop and batch cut, and ``traffic`` overrides."""
    cell = copy.deepcopy(load_cell(name))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    config_name = {w["name"]: w for w in bench["workloads"]}[name]["config"]
    cell.config = tiny_config(config_name)
    if cell.traffic["kind"] == "train_steps":
        cell.traffic.update(TRAIN)
    else:
        cell.traffic.update(pool=6, warmup_frames=2, checked_frames=3)
    cell.traffic.update(traffic)
    return cell
