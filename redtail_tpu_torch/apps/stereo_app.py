"""Stereo inference CLI (`redtail_tpu/apps/stereo_app.py`), the
`nvstereo_sample_app` equivalent for one frame pair.

Reads the two PNGs (INTER_AREA resize, BGR -> RGB, /255), runs the model
on the card (``--cpu`` for the CPU), writes the disparity as `.bin`
(rank/dims/fp32: pixels for the 3D models, [0, 1] for ``resnet18_2d``)
and as a 16-bit PNG (`main.cpp:317-330`: the 3D models' pixels x 256, the
correlation model's sigmoid output x the image width), and prints one JSON
summary line last. The 3D models run their packed head with
``REDTAIL_TPU_PACKED3D=1`` in the environment, as the JAX app does.

Weights, in the JAX app's order of preference: a TF checkpoint prefix
(``--checkpoint``, shapes included), then ``--weights``: an .npz bundle
(the golden bundles' ``disp`` is skipped) or a TRT-format blob (shapes from
the spec; ``--weights-dtype`` fp32 or fp16), then a random init from
``--seed``.

``--quantize w8`` dequantizes per-channel int8 weights at load; ``int8``
runs the 2D conv stacks as int8 x int8, calibrated on the input pair
itself. ``--accuracy GOLDEN`` (.npy, an .npz's ``disp``, or .bin) re-runs
the pair in every serving rung, ``fp32``, ``bf16``, ``bf16+packed``,
``w8``, ``int8``, and prints a D1 / EPE table against the golden
disparity (times ``--golden-scale``; a ``resnet18_2d`` golden in [0, 1]
is scaled by the width) and one JSON line of rows. "packed" is
`packed3d_lowering()`, the 3D models' packed head; the JAX package's
fused and H-packed 2D towers are TPU layouts the port does not have, so
``resnet18_2d``'s ``bf16+packed`` row runs its ``bf16`` path again. The w8
and int8 rows run under the packed head too, as in the JAX app.

``--profile-layers`` prints the per-layer device-time table
(`runtime/layer_profiler.py`) to stderr, on the frames in the form
`StereoNode` serves them: space-to-depth packed for the 3x3 stem, raw for
an int8 stem. ``--save-engine PATH`` builds an AOTInductor engine of the
configuration (dtype, rung, head) for that same input form in a pristine
subprocess (`runtime/engine_builder.py`); ``--engine PATH`` runs one on the
pair with no weights and no model code (`runtime/cache.load_engine`) and
adds ``"engine"`` to the JSON line. Inductor's persistent cache is on
(`runtime.enable_compilation_cache`) unless ``--no-cache``.

Usage:
  python -m redtail_tpu_torch.apps.stereo_app nvsmall \\
      --weights tests/data/nvsmall_golden.npz --left left.png \\
      --right right.png --out disp --dtype bf16 --quantize int8 \\
      --accuracy golden.npy
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch

RUNGS = (
    # (name, dtype, packed head, quantize)
    ("fp32", torch.float32, False, None),
    ("bf16", torch.bfloat16, False, None),
    ("bf16+packed", torch.bfloat16, True, None),
    ("w8", torch.bfloat16, True, "w8"),
    ("int8", torch.bfloat16, True, "int8"),
)


def build_argparser():
    p = argparse.ArgumentParser(description="stereo DNN inference (PyTorch)")
    p.add_argument("model", choices=["nvtiny", "nvsmall", "resnet18",
                                     "resnet18_2d"])
    p.add_argument("--checkpoint", help="TF checkpoint prefix")
    p.add_argument("--weights", help="TRT-format weight blob, or an .npz "
                   "bundle (model|scope|layer|var or scope/layer/var keys)")
    p.add_argument("--weights-dtype", default="fp32",
                   choices=["fp32", "fp16"],
                   help="the values' type in a TRT-format blob")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random init used without weights")
    p.add_argument("--left", required=True)
    p.add_argument("--right", required=True)
    p.add_argument("--out", default="disp", help="output path stem")
    p.add_argument("--dtype", default="fp32", choices=["fp32", "bf16"],
                   help="compute dtype")
    p.add_argument("--quantize", choices=["w8", "int8"],
                   help="w8: weight-only int8 (dequantized at load); int8: "
                   "calibrated int8 activations for the 2D conv stacks, "
                   "calibrated on the input pair itself")
    p.add_argument("--accuracy", metavar="GOLDEN",
                   help="run every serving rung (fp32 / bf16 / bf16+packed "
                   "/ w8 / int8) on the pair and print a D1 / EPE table "
                   "against this golden disparity (.npy, .npz 'disp' or "
                   ".bin); bf16+packed is the 3D models' packed head, the "
                   "bf16 path again for resnet18_2d")
    p.add_argument("--golden-scale", type=float, default=1.0,
                   help="multiply the golden by this to get pixels "
                   "(resnet18_2d goldens are [0, 1] and scale by the width "
                   "by themselves)")
    p.add_argument("--hw", type=int, nargs=2, metavar=("H", "W"),
                   help="override the spec input size (e.g. --hw 321 1025 "
                   "for the flagship size)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the card")
    p.add_argument("--profile", action="store_true",
                   help="print per-stage times")
    p.add_argument("--profile-layers", action="store_true",
                   help="print the per-layer ms table (each layer timed on "
                   "its real activations on the device, the reference's "
                   "printLayerTimes, main.cpp:52-81)")
    p.add_argument("--no-cache", action="store_true",
                   help="leave Inductor's persistent compilation cache off")
    p.add_argument("--save-engine", metavar="PATH",
                   help="build an AOTInductor engine of this configuration "
                   "(weights inside) at PATH, for the serving input form "
                   "(the TRT .plan equivalent, main.cpp:269-275; "
                   "device-specific)")
    p.add_argument("--engine", metavar="PATH",
                   help="run a --save-engine package: no weights, no model "
                   "code, no compilation (main.cpp:198-220); the dtype, "
                   "size and input form are the engine's")
    return p


def round_tree(params, dtype: torch.dtype):
    """The numpy param tree with every float leaf rounded to ``dtype``
    (float32 carrying its values), as the JAX app holds weights loaded in
    bf16 before it quantizes them; int8 and scale leaves as they are."""
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out[k] = round_tree(v, dtype)
        elif k in ("weights", "biases"):
            out[k] = torch.from_numpy(np.asarray(v, np.float32)).to(
                dtype).float().numpy()
        else:
            out[k] = v
    return out


def load_tree(args, spec):
    """The numpy param tree: checkpoint, then weights, then random init."""
    from redtail_tpu_torch.io import read_trt_weights
    from redtail_tpu_torch.models import (init_stereo_params,
                                          load_stereo_params,
                                          params_from_npz,
                                          params_from_trt_blob)

    if args.checkpoint:
        return load_stereo_params(args.checkpoint)
    if args.weights:
        if args.weights.endswith(".npz"):
            return params_from_npz(args.weights)
        return params_from_trt_blob(
            spec, read_trt_weights(args.weights, dtype=args.weights_dtype))
    print("warning: no weights given, using random init", file=sys.stderr)
    return init_stereo_params(spec, args.seed)


def quantized_tree(spec, tree, quantize, dtype, device, left, right):
    """The param tree of one serving configuration: ``tree`` rounded to
    ``dtype``, then quantized (``'w8'``, or ``'int8'`` calibrated on the
    pair in ``dtype`` on ``device``) or not."""
    from redtail_tpu_torch.quant import (calibrate_stereo, dequantize_tree,
                                         quantize_stereo_params_int8,
                                         quantize_stereo_params_w8)

    tree = round_tree(tree, dtype)
    if quantize == "w8":
        tree = dequantize_tree(quantize_stereo_params_w8(tree), dtype=dtype)
    elif quantize == "int8":
        scales = calibrate_stereo(spec, tree, [(left[0], right[0])],
                                  device=device, dtype=dtype)
        tree = quantize_stereo_params_int8(tree, scales)
    return tree


def quantized_net(spec, tree, quantize, dtype, device, left, right):
    """The model of one serving configuration (`quantized_tree`), built on
    ``device``."""
    from redtail_tpu_torch.models import params_from_numpy

    return params_from_numpy(
        spec, quantized_tree(spec, tree, quantize, dtype, device, left,
                             right), device=device, dtype=dtype)


def serving_frames(left, right, s2d: bool):
    """The pair as `StereoNode` feeds the net: space-to-depth packed for
    the 3x3 stem (``s2d``), else raw."""
    if not s2d:
        return left, right
    from redtail_tpu_torch.ops.space_to_depth import space_to_depth2_np

    return space_to_depth2_np(left), space_to_depth2_np(right)


def run_accuracy_table(spec, tree, left_f32, right_f32, golden_px,
                       device):
    """D1 / EPE (px, dense: every pixel counts) of each serving rung on one
    pair against a golden disparity map; ``left_f32`` / ``right_f32`` are
    (1, H, W, 3) float32 numpy."""
    from redtail_tpu_torch.ops.convolution import packed3d_lowering
    from redtail_tpu_torch.utils.metrics import disparity_errors

    dense = np.ones_like(golden_px, bool)
    w = spec.input_hw[1]
    rows = []
    for name, dtype, packed, quantize in RUNGS:
        net = quantized_net(spec, tree, quantize, dtype, device, left_f32,
                            right_f32)
        l, r = (torch.from_numpy(a).to(device=device, dtype=dtype)
                for a in (left_f32, right_f32))
        with (packed3d_lowering() if packed else contextlib.nullcontext()), \
                torch.inference_mode():
            disp = net(l, r).float().cpu().numpy()[0]
        disp_px = disp * w if spec.corr else disp
        m = disparity_errors(disp_px, golden_px, dense)
        rows.append({"rung": name, "d1": m["d1"], "epe": m["epe"],
                     "err_max": m["err_max"]})
    return rows


def read_golden(path) -> np.ndarray:
    if path.endswith(".npy"):
        return np.squeeze(np.load(path))
    if path.endswith(".npz"):
        # the golden bundles (tests/data/*_golden.npz) carry the
        # reference-graph disparity under 'disp'
        return np.squeeze(np.load(path)["disp"])
    from redtail_tpu_torch.io import read_bin
    return np.squeeze(read_bin(path))


def write_outputs(disp, out, corr: bool, w: int):
    """The disparity as `.bin` and as a 16-bit PNG (`main.cpp:325-327`: the
    3D models' pixels x 256, the correlation model's [0, 1] x the width);
    returns the `.bin` path."""
    import cv2

    from redtail_tpu_torch.io import write_bin

    out = Path(out)
    write_bin(disp, out.with_suffix(".bin"))
    scale = w if corr else 256.0
    png = np.clip(disp * scale, 0, 65535).astype(np.uint16)
    cv2.imwrite(str(out.with_suffix(".png")), png)
    return out.with_suffix(".bin")


def read_pair(args, h: int, w: int, dtype: torch.dtype):
    """The pair at (h, w) in ``dtype``, carried as float32 numpy (1, h, w,
    3)."""
    import cv2

    from redtail_tpu_torch.ops.preprocess import preprocess_stereo_host

    return tuple(
        torch.from_numpy(preprocess_stereo_host(cv2.imread(p), w, h)[None])
        .to(dtype).float().numpy() for p in (args.left, args.right))


def run_engine(args, device, prof):
    """The plan-file flow (`main.cpp:198-220`): load the engine, run it on
    the pair in its own dtype, size and input form; imports no model code.
    Returns the engine's call and the inputs it ran on."""
    from redtail_tpu_torch.runtime.cache import load_engine

    with prof.stage("load_engine"):
        call, extras = load_engine(args.engine, device)
    if extras["model"] != args.model:
        raise ValueError(f"engine {args.engine} runs {extras['model']}, not "
                         f"{args.model}")
    dtype = torch.bfloat16 if extras["dtype"] == "bf16" else torch.float32
    h, w = extras["input_hw"]
    with prof.stage("preprocess"):
        left, right = serving_frames(*read_pair(args, h, w, dtype),
                                     s2d=extras["input_shape"][-1] == 12)
    inputs = tuple(torch.from_numpy(a).to(device=device, dtype=dtype)
                   for a in (left, right))
    with prof.stage("execute"):
        disp = call(*inputs).float().cpu().numpy()[0]
    out = write_outputs(disp, args.out, args.model == "resnet18_2d", w)
    if args.profile:
        print(prof.report(), file=sys.stderr)
    print(json.dumps({"model": args.model, "shape": list(disp.shape),
                      "disp_mean": float(disp.mean()),
                      "engine": args.engine, "out": str(out)}))
    return call, inputs


def main(argv=None):
    args = build_argparser().parse_args(argv)

    from redtail_tpu_torch import resolve_device
    from redtail_tpu_torch.runtime import StageProfiler, enable_compilation_cache

    device = resolve_device("cpu" if args.cpu else None)
    if not args.no_cache:
        enable_compilation_cache(device=device)
    prof = StageProfiler()
    if args.engine:
        run_engine(args, device, prof)
        return

    from redtail_tpu_torch.models import STEREO_SPECS, params_from_numpy

    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    spec = STEREO_SPECS[args.model]
    if args.hw:
        spec = dataclasses.replace(spec, input_hw=tuple(args.hw))
    with prof.stage("load_weights"):
        tree = load_tree(args, spec)
    h, w = spec.input_hw
    with prof.stage("preprocess"):
        left, right = read_pair(args, h, w, dtype)
    with prof.stage("calibrate" if args.quantize == "int8"
                    else "build"):
        qtree = quantized_tree(spec, tree, args.quantize, dtype, device,
                               left, right)
        net = params_from_numpy(spec, qtree, device=device, dtype=dtype)
    with prof.stage("execute"), torch.inference_mode():
        disp = net(*(torch.from_numpy(a).to(device=device, dtype=dtype)
                     for a in (left, right))).float().cpu().numpy()[0]

    # the serving input form: an int8 stem has no s2d form (StereoNode)
    served = serving_frames(left, right, s2d=args.quantize != "int8")
    if args.save_engine:
        from redtail_tpu_torch.runtime.engine_builder import (
            build_stereo_engine)
        with prof.stage("save_engine"):
            summary = build_stereo_engine(args.save_engine, spec, qtree,
                                          served[0].shape, dtype=args.dtype,
                                          cpu=device.type == "cpu")
        print(summary, file=sys.stderr)

    if args.profile_layers:
        from redtail_tpu_torch.runtime.layer_profiler import (
            device_peaks, format_layer_table, profile_stereo_layers)
        with prof.stage("profile_layers"):
            rows, e2e = profile_stereo_layers(
                net, *(torch.from_numpy(a).to(device=device, dtype=dtype)
                       for a in served))
        print(format_layer_table(rows, e2e, device_peaks(device)),
              file=sys.stderr)

    if args.accuracy:
        golden = read_golden(args.accuracy)
        golden_px = golden * w if spec.corr else golden * args.golden_scale
        rows = run_accuracy_table(spec, tree, left, right, golden_px, device)
        print(f"{'rung':<12s} {'D1 %':>8s} {'EPE px':>8s} {'max px':>8s}",
              file=sys.stderr)
        for r in rows:
            print(f"{r['rung']:<12s} {100 * r['d1']:8.3f} "
                  f"{r['epe']:8.4f} {r['err_max']:8.3f}", file=sys.stderr)
        print(json.dumps({"model": args.model, "accuracy": rows}))

    out = write_outputs(disp, args.out, spec.corr, w)
    if args.profile:
        print(prof.report(), file=sys.stderr)
    print(json.dumps({"model": args.model, "shape": list(disp.shape),
                      "disp_mean": float(disp.mean()), "out": str(out)}))


if __name__ == "__main__":
    main()
