"""What the benchmark takes from the program, `redtail_tpu_torch`: the
network spec built from the configuration file (and held equal to the
program's published spec of that name), the serving node, the train
step, and the program's own stage timings. Nothing else of the harness
imports the program.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict

import torch
from redtail_tpu_torch.models.stereo import (STEREO_SPECS, Conv3dLayer,
                                             StereoSpec)
from redtail_tpu_torch.ops.convolution import packed3d_lowering
from redtail_tpu_torch.parallel.training import (OptimizerSpec,
                                                 make_train_step)
from redtail_tpu_torch.runtime.graph import Stamped
from redtail_tpu_torch.runtime.nodes import StereoNode
from redtail_tpu_torch.runtime.profiler import StageProfiler

from portbench.reference.stereo import layer_table

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
CALIB_PAIRS = 4  # pool pairs the int8 rung is calibrated on
BETA1 = 0.9  # Adam's first-moment decay, torch's default and optax's


def port_spec(config: dict):
    """The program's `StereoSpec` of the configuration (the correlation
    family's ``corr``, ``bneck_channels`` and ``bneck_dec`` passed through
    under `StereoSpec`'s own names); where the file names a published spec
    (``port_spec``), the two networks must be equal at the file's input
    size (a spec's ``input_hw`` is the size it shipped at; any works)."""
    spec = StereoSpec(
        name=config["model"], input_hw=tuple(config["input_hw"]),
        max_disp=config["max_disp"], encoder2d=config["encoder2d"],
        enc2d_channels=tuple(config["enc2d_channels"]),
        enc3d=tuple(Conv3dLayer(n, c, s) for n, c, s in config["enc3d"]),
        dec3d=tuple((n, c, s) for n, c, s in config["dec3d"]),
        corr=bool(config.get("corr", False)),
        bneck_channels=tuple(tuple(layer) for layer
                             in config.get("bneck_channels", ())),
        bneck_dec=tuple(tuple(layer) for layer in config.get("bneck_dec",
                                                             ())))
    published = config.get("port_spec")
    if published is not None:
        want = dataclasses.replace(STEREO_SPECS[published],
                                   input_hw=spec.input_hw)
        if want != spec:
            raise ValueError(f"the configuration's network differs from "
                             f"the program's '{published}': {want}")
    return spec


def head_context(config: dict):
    """The 3D head the configuration serves: the program's default fused
    head, or its packed head."""
    head = config.get("head", "fused")
    if head == "fused":
        return contextlib.nullcontext()
    if head == "packed":
        return packed3d_lowering()
    raise ValueError(f"unknown head {head!r}")


def make_node(spec, config: dict, traffic: dict, tree, device, *,
              frames=None):
    """The serving node as `pipeline_app` deploys it, with the traffic's
    frames in flight, microbatch and wire format, and the configuration's
    rung (``quantize``: none, ``"w8"`` or ``"int8"``, the last calibrated
    on the first ``CALIB_PAIRS`` of ``frames``, the pool's (left, right))."""
    quantize = config.get("quantize")
    calib = None
    if quantize == "int8":
        left, right = frames
        calib = list(zip(left[:CALIB_PAIRS], right[:CALIB_PAIRS]))
    return StereoNode(spec, tree, dtype=DTYPES[config["dtype"]],
                      device=device, overlap=traffic["overlap"],
                      microbatch=traffic["microbatch"], wire=traffic["wire"],
                      quantize=quantize, calib_frames=calib,
                      profiler=StageProfiler())


def results(out) -> list:
    """The host results a node call returned: none, one, or a
    microbatch's."""
    if out is None:
        return []
    items = out if isinstance(out, list) else [out]
    return [r.data if isinstance(r, Stamped) else r for r in items]


def stage_means_ms(node) -> Dict[str, float]:
    """Mean ms of each of the node's stages since its profiler's reset."""
    return {k: v["mean_ms"] for k, v in node.profiler.stats().items()}


class PortTrainer:
    """The program's train step (`make_train_step`), its state, and what
    the check reads of it: the loss of each step, the first gradient as
    the optimizer holds it after one step, the masters' change."""

    def __init__(self, spec, config: dict, traffic: dict, tree, device):
        train = config["train"]
        if train["optimizer"] != "adam":
            raise ValueError("the reference trains with Adam only")
        init_fn, self.step_fn = make_train_step(
            spec, OptimizerSpec("adam", train["lr"]),
            remat=train["remat"], compute_dtype=DTYPES[config["dtype"]],
            device=device)
        self.state = init_fn(tree)
        self.paths = [path for path, _k, _b in layer_table(config)]

    def step(self, batch):
        self.state, metrics = self.step_fn(self.state, *batch)
        return metrics["loss"]

    def leaves(self) -> Dict[str, torch.Tensor]:
        net = self.state.params
        out = {}
        for path in self.paths:
            layer = net.get_submodule(path.replace("/", "."))
            out[f"{path}/weights"] = layer.weight
            out[f"{path}/biases"] = layer.bias
        return out

    def first_grads(self) -> Dict[str, torch.Tensor]:
        """After the first update: Adam's first moment is (1 - beta1) g."""
        state = self.state.opt_state.state
        return {k: state[p]["exp_avg"] / (1 - BETA1)
                for k, p in self.leaves().items()}

