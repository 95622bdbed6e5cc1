"""Stereo inference CLI (`redtail_tpu/apps/stereo_app.py`), the
`nvstereo_sample_app` equivalent for one frame pair.

Reads the two PNGs (INTER_AREA resize, BGR -> RGB, /255), runs the model
on the card (``--cpu`` for the CPU), writes the disparity as `.bin`
(rank/dims/fp32: pixels for the 3D models, [0, 1] for ``resnet18_2d``)
and as a 16-bit PNG (`main.cpp:317-330`: the 3D models' pixels x 256, the
correlation model's sigmoid output x the image width), and prints one JSON
summary line. Weights come from an .npz bundle (``--weights``; the golden
bundles' bundled ``disp`` is skipped) or random init from ``--seed``.

Usage:
  python -m redtail_tpu_torch.apps.stereo_app nvsmall \
      --weights tests/data/nvsmall_golden.npz --left left.png \
      --right right.png --out disp --dtype bf16
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch


def build_argparser():
    p = argparse.ArgumentParser(description="stereo DNN inference (PyTorch)")
    p.add_argument("model", choices=["nvtiny", "nvsmall", "resnet18",
                                     "resnet18_2d"])
    p.add_argument("--weights", help="an .npz bundle (model|scope|layer|var "
                   "or scope/layer/var keys)")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random init used without --weights")
    p.add_argument("--left", required=True)
    p.add_argument("--right", required=True)
    p.add_argument("--out", default="disp", help="output path stem")
    p.add_argument("--dtype", default="fp32", choices=["fp32", "bf16"],
                   help="compute dtype")
    p.add_argument("--hw", type=int, nargs=2, metavar=("H", "W"),
                   help="override the spec input size (e.g. --hw 321 1025 "
                   "for the flagship size)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the card")
    p.add_argument("--profile", action="store_true",
                   help="print per-stage times")
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)

    from redtail_tpu_torch import resolve_device

    device = resolve_device("cpu" if args.cpu else None)

    import cv2

    from redtail_tpu_torch.io import write_bin
    from redtail_tpu_torch.models import (
        STEREO_SPECS, init_stereo_params, params_from_npz, params_from_numpy)
    from redtail_tpu_torch.ops.preprocess import preprocess_stereo_host
    from redtail_tpu_torch.runtime import StageProfiler

    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    spec = STEREO_SPECS[args.model]
    if args.hw:
        spec = dataclasses.replace(spec, input_hw=tuple(args.hw))
    prof = StageProfiler()
    with prof.stage("load_weights"):
        if args.weights:
            tree = params_from_npz(args.weights)
        else:
            print("warning: no weights given, using random init",
                  file=sys.stderr)
            tree = init_stereo_params(spec, args.seed)
        net = params_from_numpy(spec, tree, device=device, dtype=dtype)
    h, w = spec.input_hw
    with prof.stage("preprocess"):
        left, right = (
            torch.from_numpy(preprocess_stereo_host(cv2.imread(p), w, h)[None])
            .to(device=device, dtype=dtype) for p in (args.left, args.right))
    with prof.stage("execute"), torch.inference_mode():
        disp = net(left, right).float().cpu().numpy()[0]  # (H, W)

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
