"""D1 / EPE between two disparity maps (`tools/eval_disparity.py`), the
reference's headline metric (`stereoDNN/README.md:28-31,35-36`), which it
shipped without a tool.

Reads `.npy`, the `.bin` tensor format (rank, dims, fp32 payload;
`io/golden.py`) or a 16-bit PNG as `stereo_app` writes it (``--png-scale``
undoes the write-time scale: 256 for the 3D models, the image width for
``resnet18_2d``). Prints `utils.metrics.disparity_errors` as one JSON
line. Imports nothing of JAX.

Usage:
  python -m redtail_tpu_torch.apps.eval_disparity pred.npy golden.npy --dense
  python -m redtail_tpu_torch.apps.eval_disparity disp.png golden.npy \\
      --png-scale 256
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np


def load_disparity(path: str, png_scale: float = 256.0) -> np.ndarray:
    p = Path(path)
    if p.suffix == ".npy":
        arr = np.load(p)
    elif p.suffix == ".bin":
        from redtail_tpu_torch.io import read_bin
        arr = read_bin(p)
    elif p.suffix in (".png", ".pgm"):
        import cv2
        arr = cv2.imread(str(p), cv2.IMREAD_UNCHANGED).astype(np.float32)
        arr = arr / png_scale
    else:
        raise ValueError(f"unsupported disparity format: {p.suffix}")
    return np.squeeze(np.asarray(arr, np.float32))


def build_argparser():
    ap = argparse.ArgumentParser(description="D1/EPE disparity evaluation")
    ap.add_argument("pred")
    ap.add_argument("gt")
    ap.add_argument("--png-scale", type=float, default=256.0,
                    help="divide PNG values by this (256 for the 3D models, "
                    "the image width for resnet18_2d)")
    ap.add_argument("--dense", action="store_true",
                    help="every pixel valid (a dense reference such as a "
                    "golden model output) instead of gt > 0 sparse")
    return ap


def main(argv=None) -> None:
    args = build_argparser().parse_args(argv)

    from redtail_tpu_torch.utils.metrics import disparity_errors

    pred = load_disparity(args.pred, args.png_scale)
    gt = load_disparity(args.gt, args.png_scale)
    valid = np.ones_like(gt, bool) if args.dense else None
    print(json.dumps(disparity_errors(pred, gt, valid)))


if __name__ == "__main__":
    main()
