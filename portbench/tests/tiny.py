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


# ResNet18-2D (redtail's `stereoDNN/sample_app/resnet18_2D_513x257_net.cpp`)
# at the deployed 321x1025, as a configuration file of the correlation
# family states it: the program's `STEREO_SPECS["resnet18_2d"]` network.
RESNET18_2D = {
    "name": "resnet18_2d-321x1025-bf16",
    "source": "https://github.com/NVIDIA-AI-IOT/redtail/blob/master/"
              "stereoDNN/sample_app/resnet18_2D_513x257_net.cpp",
    "model": "resnet18_2d", "port_spec": "resnet18_2d",
    "input_hw": [321, 1025], "max_disp": 48,
    "encoder2d": "resnet18", "enc2d_channels": [32],
    "enc3d": [], "dec3d": [], "corr": True,
    "bneck_channels": [["conv2D_1", 32, 1], ["conv2D_2", 32, 1],
                       ["conv2D_3ds", 64, 2], ["conv2D_4", 64, 1],
                       ["conv2D_5", 64, 1], ["conv2D_6ds", 128, 2],
                       ["conv2D_7", 128, 1], ["conv2D_8", 128, 1]],
    "bneck_dec": [["deconv2D_1", 64, "conv2D_5"],
                  ["deconv2D_2", 32, "conv2D_2"], ["deconv2D_3", 1, None]],
    "dtype": "bfloat16", "head": "fused",
    "train": {"optimizer": "adam", "lr": 0.0001, "remat": True,
              "loss": "smooth_l1", "delta": 1.0},
    "reduced": [],
}


def _small(config: dict) -> dict:
    """``config`` at a test's size: 32x96 frames, max_disp 16."""
    config = copy.deepcopy(config)
    config.pop("port_spec")
    config["model"] = "tiny_" + config["model"]
    config["input_hw"] = list(SERVE_HW)
    config["max_disp"] = 16
    return config


def tiny_config(name: str) -> dict:
    """The configuration ``name`` of `BENCHMARK.json` at a test's size:
    its published widths, 32x96 frames, max_disp 16."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    conf = {c["name"]: c for c in bench["configs"]}[name]
    return _small(json.loads((ROOT / conf["file"]).read_text()))


def tiny_corr_config() -> dict:
    """`RESNET18_2D` at a test's size."""
    return _small(RESNET18_2D)


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
