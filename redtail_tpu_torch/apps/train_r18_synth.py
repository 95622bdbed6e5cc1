"""Train ResNet-18 3D from scratch on synthetic stereo and print its rung
table (`tools/train_r18_synth.py`), on the card unless ``--cpu``.

The upstream ResNet-18 3D checkpoint was never mirrored, so the model's
rung table needs weights trained here: synthetic variable-disparity stereo
(`data.kitti.make_synthetic_kitti`, training seed 0, held-out seed 1) is
trained with `training.stereo.train_stereo` until the held-out D1 passes
``--d1-gate``; the params are saved rounded to bf16 (``@bf16`` keys, the
JAX package's encoding, which its `params_from_npz` reads) and, with
``--rungs``, the serving rungs are measured with them. A failed gate exits
1 and writes nothing. The port's random init is numpy's, not
`jax.random`'s, so a run reaches the committed checkpoint's gate
(`tests/data/resnet18_synth_trained.npz`, made by the JAX tool), not its
bits. Imports nothing of JAX.

Usage:
  python -m redtail_tpu_torch.apps.train_r18_synth --rungs
  python -m redtail_tpu_torch.apps.train_r18_synth --cpu --crop 32x64 \\
      --max-disp 8 --steps 2 --n-train 2 --n-eval 1 --batch 1 --d1-gate 1
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import tempfile
from pathlib import Path

import numpy as np

# Not tests/data/: the committed checkpoint there is the JAX tool's, and a
# run of this tool must not overwrite it.
DEFAULT_OUT = (Path(__file__).resolve().parents[1] / "build"
               / "resnet18_synth_trained.npz")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--out", default=str(DEFAULT_OUT),
                    help="where the bf16 params go (default under the "
                         "package's build/, which git ignores; not "
                         "tests/data/, whose committed checkpoint this "
                         "run must not overwrite)")
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--crop", default="160x512")
    ap.add_argument("--max-disp", type=int, default=24,
                    help="cost-volume D at half res (full = 2x)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--n-train", type=int, default=48)
    ap.add_argument("--n-eval", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=None,
                    help="resumable train-state dir (rerun the same "
                         "command to continue toward --steps)")
    ap.add_argument("--d1-gate", type=float, default=0.02,
                    help="held-out D1 the run must reach")
    ap.add_argument("--rungs", action="store_true",
                    help="also print the serving rung table (bf16/packed/"
                         "w8 vs the fp32 forward + D1 vs GT)")
    ap.add_argument("--cpu", action="store_true",
                    help="train and evaluate on the CPU instead of the card")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    return run(parse_args(argv))


def bf16_tree(params):
    """A nested tree of float32 arrays as CPU ``torch.bfloat16`` tensors,
    each rounded to nearest even (the rounding of `ml_dtypes`, which the
    JAX tool uses): what `utils.checkpoint.save_params` writes as ``@bf16``
    leaves."""
    import torch

    if isinstance(params, dict):
        return {k: bf16_tree(v) for k, v in params.items()}
    return torch.from_numpy(np.asarray(params, np.float32)).to(
        torch.bfloat16)


def run(args: argparse.Namespace, init_params=None) -> int:
    """The tool on parsed ``args``. ``init_params``: a nested numpy tree to
    start from instead of the port's seeded init (the JAX package's, say).
    It enters as a step-0 train state in the checkpoint directory (a
    temporary one without ``--ckpt-dir``), which `train_stereo` resumes
    from; an existing checkpoint there takes precedence."""
    from redtail_tpu_torch import resolve_device
    from redtail_tpu_torch.data.kitti import (KittiStereoDataset,
                                              make_synthetic_kitti)
    from redtail_tpu_torch.models import STEREO_SPECS
    from redtail_tpu_torch.models.stereo import params_to_numpy
    from redtail_tpu_torch.training.stereo import (StereoTrainConfig,
                                                   evaluate_stereo,
                                                   train_stereo)
    from redtail_tpu_torch.utils.checkpoint import save_params

    device = resolve_device("cpu" if args.cpu else None)  # before the data
    h, w = (int(s) for s in args.crop.lower().split("x"))
    full_d = 2 * args.max_disp
    with tempfile.TemporaryDirectory() as td:
        # Disparity range inside the model's representable [0, full_d):
        # varied per image so the net must correlate, not regress a bias.
        train_root = make_synthetic_kitti(
            Path(td) / "train", n=args.n_train, hw=(h, w),
            disp=(4, full_d - 8), seed=0, octaves=3)
        eval_root = make_synthetic_kitti(
            Path(td) / "eval", n=args.n_eval, hw=(h, w),
            disp=(4, full_d - 8), seed=1, octaves=3)
        train_ds = KittiStereoDataset(train_root)
        eval_ds = KittiStereoDataset(eval_root)

        ckpt_dir = args.ckpt_dir
        if init_params is not None and ckpt_dir is None:
            ckpt_dir = str(Path(td) / "ckpt")
        cfg = StereoTrainConfig(
            model="resnet18", crop_hw=(h, w), max_disp=args.max_disp,
            batch_size=args.batch, steps=args.steps, lr=args.lr,
            warmup_steps=min(100, args.steps // 10), dtype=args.dtype,
            ckpt_dir=ckpt_dir, ckpt_every=200 if args.ckpt_dir else 0,
            resume=bool(ckpt_dir))
        if init_params is not None:
            _seed_train_state(cfg, init_params)
        state = train_stereo(cfg, train_ds, eval_dataset=eval_ds,
                             device=device)

        spec = dataclasses.replace(STEREO_SPECS["resnet18"],
                                   input_hw=(h, w), max_disp=args.max_disp)
        ev = evaluate_stereo(spec, state.params, eval_ds)
        print(json.dumps({"final_eval": ev}), flush=True)
        if ev["d1"] > args.d1_gate:
            print(json.dumps({"error": "d1 gate failed",
                              "d1": ev["d1"], "gate": args.d1_gate}))
            return 1

        out = Path(args.out)
        save_params(bf16_tree(params_to_numpy(state.params)), out)
        print(json.dumps({"params": str(out),
                          "bytes": out.stat().st_size}), flush=True)

        if args.rungs:
            print_rung_table(spec, out, eval_ds, device=device)
    return 0


def _seed_train_state(cfg, init_params) -> None:
    """Write ``init_params`` as a step-0 train state (optimizer moments 0)
    where `train_stereo` resumes from, unless a checkpoint is there."""
    import torch

    from redtail_tpu_torch.parallel.training import make_train_step
    from redtail_tpu_torch.training.stereo import (DTYPES, _make_optimizer,
                                                   _make_spec,
                                                   save_train_state,
                                                   train_state_path)

    path = train_state_path(cfg)
    if path.exists():
        return
    init_fn, _ = make_train_step(_make_spec(cfg), _make_optimizer(cfg),
                                 compute_dtype=DTYPES[cfg.dtype],
                                 device="cpu")
    with torch.no_grad():
        save_train_state(init_fn(init_params), path)


# the launches each rung's head makes, per frame, on the card
RUNG_HEADS = {"fp32": "fused", "bf16": "fused", "bf16+packed": "packed",
              "w8": "fused"}


def _counts():
    from redtail_tpu_torch.kernels.conv223 import conv223
    from redtail_tpu_torch.kernels.cost_volume_concat import \
        cost_volume_concat
    from redtail_tpu_torch.kernels.fused_cv_emit import fused_cv_emit

    return {"fused_cv_emit": fused_cv_emit.launches
            - fused_cv_emit.packed_launches,
            "fused_cv_emit.packed": fused_cv_emit.packed_launches,
            "conv223": conv223.launches,
            "cost_volume_concat": cost_volume_concat.launches}


def print_rung_table(spec, weights_npz, eval_ds, *, device=None):
    """Serving rung table with the trained weights: D1 / EPE of each rung
    vs the fp32 forward (drift) and vs the synthetic GT (accuracy), on the
    first held-out pair. Prints the JAX tool's JSON line a rung and returns
    the rows unrounded, each with the kernel launches its forward made
    (``launches``). The fused rows run the emission kernel, ``bf16+packed``
    the packed head (`packed3d_lowering()`: the emission's packed layout
    and conv223); on the card a row whose forward did not launch its
    head's kernels, or launched the concat kernel, raises."""
    import contextlib

    import torch

    from redtail_tpu_torch import resolve_device
    from redtail_tpu_torch.models import params_from_npz, params_from_numpy
    from redtail_tpu_torch.ops.convolution import packed3d_lowering
    from redtail_tpu_torch.quant import (dequantize_tree,
                                         quantize_stereo_params_w8)
    from redtail_tpu_torch.utils.metrics import disparity_errors

    dev = resolve_device(device)
    params32 = params_from_npz(weights_npz)
    left, right, gt, valid = eval_ds.sample(0)

    def run(params, dtype, head):
        net = params_from_numpy(spec, params, device=dev, dtype=dtype)
        lowering = packed3d_lowering if head == "packed" \
            else contextlib.nullcontext
        before = _counts()
        with torch.inference_mode(), lowering():
            pred = net(torch.from_numpy(left[None]).to(dev, dtype),
                       torch.from_numpy(right[None]).to(dev, dtype))
        pred = pred.float().cpu().numpy()[0]
        return pred, {k: v - before[k] for k, v in _counts().items()}

    # w8 serving rung = fake-quant weights, fp32 conv (the stereo_app
    # --accuracy convention)
    trees = {"fp32": (params32, torch.float32),
             "bf16": (params32, torch.bfloat16),
             "bf16+packed": (params32, torch.bfloat16),
             "w8": (dequantize_tree(quantize_stereo_params_w8(params32)),
                    torch.float32)}
    preds = {name: run(tree, dtype, RUNG_HEADS[name])
             for name, (tree, dtype) in trees.items()}
    golden = preds["fp32"][0]
    rows = []
    for name, (pred, launches) in preds.items():
        if dev.type == "cuda":
            _check_head(name, launches)
        drift = disparity_errors(pred, golden,
                                 valid=np.ones_like(golden, bool))
        acc = disparity_errors(pred, gt, valid=valid > 0)
        row = {"rung": name, "d1_vs_fp32": drift["d1"],
               "epe_vs_fp32": drift["epe"], "d1_vs_gt": acc["d1"],
               "epe_vs_gt": acc["epe"]}
        print(json.dumps({"rung": name,
                          "d1_vs_fp32": round(drift["d1"], 5),
                          "epe_vs_fp32": round(drift["epe"], 4),
                          "d1_vs_gt": round(acc["d1"], 5),
                          "epe_vs_gt": round(acc["epe"], 4)}), flush=True)
        rows.append({**row, "pred": pred, "launches": launches})
    return rows


def _check_head(name: str, launches: dict) -> None:
    """A card forward of rung ``name`` made one frame's launches of its
    head: the emission (full layout) for the fused head, the packed
    emission and conv223 (ResNet-18 3D's conv3D_1b) for the packed one;
    the concat kernel never."""
    packed = int(RUNG_HEADS[name] == "packed")
    want = {"fused_cv_emit": 1 - packed, "fused_cv_emit.packed": packed,
            "conv223": packed, "cost_volume_concat": 0}
    if launches != want:
        raise RuntimeError(f"rung {name}: the {RUNG_HEADS[name]} head did "
                           f"not run as built (launches {launches})")


if __name__ == "__main__":
    import sys
    sys.exit(main())
