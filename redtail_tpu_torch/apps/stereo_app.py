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
``--profile-layers``, ``--save-engine`` and ``--engine`` are not ported
(ROADMAP.md, module queue item 8).

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


def quantized_net(spec, tree, quantize, dtype, device, left, right):
    """The model of one serving configuration: ``tree`` rounded to
    ``dtype``, then quantized (``'w8'``, or ``'int8'`` calibrated on the
    pair in ``dtype``) or not, built on ``device``."""
    from redtail_tpu_torch.models import params_from_numpy
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
    return params_from_numpy(spec, tree, device=device, dtype=dtype)


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


def main(argv=None):
    args = build_argparser().parse_args(argv)

    from redtail_tpu_torch import resolve_device

    device = resolve_device("cpu" if args.cpu else None)

    import cv2

    from redtail_tpu_torch.io import write_bin
    from redtail_tpu_torch.models import STEREO_SPECS
    from redtail_tpu_torch.ops.preprocess import preprocess_stereo_host
    from redtail_tpu_torch.runtime import StageProfiler

    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    spec = STEREO_SPECS[args.model]
    if args.hw:
        spec = dataclasses.replace(spec, input_hw=tuple(args.hw))
    prof = StageProfiler()
    with prof.stage("load_weights"):
        tree = load_tree(args, spec)
    h, w = spec.input_hw
    with prof.stage("preprocess"):
        # the pair in the compute dtype, carried as float32 numpy
        left, right = (
            torch.from_numpy(preprocess_stereo_host(cv2.imread(p), w, h)[None])
            .to(dtype).float().numpy() for p in (args.left, args.right))
    with prof.stage("calibrate" if args.quantize == "int8"
                    else "build"):
        net = quantized_net(spec, tree, args.quantize, dtype, device, left,
                            right)
    with prof.stage("execute"), torch.inference_mode():
        disp = net(*(torch.from_numpy(a).to(device=device, dtype=dtype)
                     for a in (left, right))).float().cpu().numpy()[0]

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

    out = Path(args.out)
    write_bin(disp, out.with_suffix(".bin"))
    scale = w if spec.corr else 256.0  # `main.cpp:325-327`
    png = np.clip(disp * scale, 0, 65535).astype(np.uint16)
    cv2.imwrite(str(out.with_suffix(".png")), png)
    if args.profile:
        print(prof.report(), file=sys.stderr)
    print(json.dumps({"model": args.model, "shape": list(disp.shape),
                      "disp_mean": float(disp.mean()),
                      "out": str(out.with_suffix(".bin"))}))


if __name__ == "__main__":
    main()
