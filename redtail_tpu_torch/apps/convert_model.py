"""Model conversion CLI (`tools/convert_model.py`), the reference's
`model_builder.py` without code generation: the models are spec-driven, so
conversion re-packages weights between the formats the port reads.

    TF checkpoint prefix  --read-->  param tree  --write-->  .npz bundle
    TRT weight blob       --read-->              --write-->  TRT blob

The blob is the reference writer's (`tensorrt_model_builder.py:52-60`):
the identity scale weights it always emitted, then every layer in the
spec's order, 2D kernels KCRS and 3D ones KVCRS, the siamese tower under
both `left_` and `right_` names; fp32 or fp16 values. Its bytes equal the
JAX tool's; the .npz is `utils.checkpoint.save_params`'s, which both
packages read. A checkpoint's leaves keep their stored dtype (bf16 read as
fp32), as the JAX tool's do. Prints one JSON line, ``{"model": ...,
"wrote": [...]}``. Imports nothing of JAX.

Usage:
  python -m redtail_tpu_torch.apps.convert_model --model nvtiny \\
      --checkpoint .../model-inference-513x161-0 \\
      --out-blob trt_weights.bin --blob-dtype fp16 --out-npz params.npz
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict

import numpy as np

MODELS = ("nvtiny", "nvsmall", "resnet18", "resnet18_2d")


def tree_to_blob(spec, params) -> Dict[str, np.ndarray]:
    """Nested param tree -> the reference writer's flat blob dict, in its
    order (`tools/convert_model.py:tree_to_blob`); the inverse of
    `models.stereo.params_from_trt_blob`."""
    from redtail_tpu_torch.models.stereo import _spec_layer_shapes

    blob = {}
    for side in ("left", "right"):
        blob[f"{side}_scale_shift"] = np.zeros(1, np.float32)
        blob[f"{side}_scale_scale"] = np.ones(1, np.float32)
        blob[f"{side}_scale_power"] = np.ones(1, np.float32)
    for path, kshape, _ in _spec_layer_shapes(spec):
        leaf = params
        for part in path.split("/"):
            leaf = leaf[part]
        w, b = np.asarray(leaf["weights"]), np.asarray(leaf["biases"])
        wk = np.transpose(w, (3, 2, 0, 1) if len(kshape) == 4
                          else (4, 0, 3, 1, 2))
        layer = path.split("/", 1)[1].replace("/", "_")
        names = ([f"left_{layer}", f"right_{layer}"]
                 if path.startswith("encoder2D") else [layer])
        for name in names:
            blob[f"{name}_k"] = wk
            blob[f"{name}_b"] = b
    return blob


def checkpoint_tree(prefix):
    """A TF checkpoint as the nested param dict, each leaf in its stored
    dtype (a leading `model` scope dropped)."""
    from redtail_tpu_torch.io import load_checkpoint

    params = {}
    for name, arr in load_checkpoint(prefix).items():
        parts = name.split("/")
        if parts[0] == "model":
            parts = parts[1:]
        node = params
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = arr
    return params


def build_argparser():
    p = argparse.ArgumentParser(description="stereo weight conversion")
    p.add_argument("--model", required=True, choices=MODELS)
    p.add_argument("--checkpoint", help="TF checkpoint prefix to read")
    p.add_argument("--in-blob", help="TRT blob to read instead")
    p.add_argument("--in-blob-dtype", default="fp32",
                   choices=["fp32", "fp16"])
    p.add_argument("--out-blob", help="write a TRT-format blob here")
    p.add_argument("--blob-dtype", default="fp32", choices=["fp32", "fp16"])
    p.add_argument("--out-npz", help="write an .npz param bundle here")
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)

    from redtail_tpu_torch.io import read_trt_weights, write_trt_weights
    from redtail_tpu_torch.models.stereo import (STEREO_SPECS,
                                                 params_from_trt_blob)
    from redtail_tpu_torch.utils.checkpoint import save_params

    spec = STEREO_SPECS[args.model]
    if args.checkpoint:
        params = checkpoint_tree(args.checkpoint)
    elif args.in_blob:
        params = params_from_trt_blob(
            spec, read_trt_weights(args.in_blob, dtype=args.in_blob_dtype))
    else:
        print("need --checkpoint or --in-blob", file=sys.stderr)
        return 1
    wrote = []
    if args.out_blob:
        write_trt_weights(tree_to_blob(spec, params), args.out_blob,
                          dtype=args.blob_dtype)
        wrote.append(args.out_blob)
    if args.out_npz:
        save_params(params, args.out_npz)
        wrote.append(args.out_npz)
    print(json.dumps({"model": args.model, "wrote": wrote}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
