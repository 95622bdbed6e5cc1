"""Training CLI (`redtail_tpu/apps/train_app.py`): the stereo disparity
nets and TrailNet, on the card unless ``--cpu``.

The forward functions trained here are the ones the port serves, so a
trained ``--out`` bundle drops into `stereo_app --weights` or, for TrailNet,
`models.trailnet.params_from_numpy` and `TrailNetNode`; the bundles are the
JAX package's format too (`utils/checkpoint.py`).

Usage:
  python -m redtail_tpu_torch.apps.train_app stereo --data <kitti_dir> \\
      --model resnet18_2d --steps 2000 --batch 4 --crop 160x512 \\
      --dtype bfloat16 --ckpt-dir ckpts --out resnet18_2d.npz
  python -m redtail_tpu_torch.apps.train_app trailnet --data <trails_root> \\
      --steps 500 --batch 16 --out trailnet.npz --export-caffe trailnet

Progress is emitted as JSON lines. ``stereo --data-parallel N`` trains in
N ranks (`parallel/launch.py`), each over its slice of every global batch:
NCCL with a card a rank, or with ``--cpu`` gloo ranks on the CPU; fewer
cards than N raise. Rank 0 logs and writes the checkpoints and ``--out``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def _parse_hw(s: str):
    h, w = s.lower().split("x")
    return (int(h), int(w))


def _device(args):
    from redtail_tpu_torch import resolve_device

    return resolve_device("cpu" if args.cpu else None)


# ----------------------------------------------------------------- stereo


def _run_stereo(args) -> int:
    if args.data_parallel > 1:
        from redtail_tpu_torch.parallel.launch import spawn_ranks

        backend, device_type = ("gloo", "cpu") if args.cpu \
            else ("nccl", "cuda")
        spawn_ranks(_stereo_rank, args.data_parallel, backend=backend,
                    device_type=device_type, args=(args,))
        return 0
    return _train_stereo(args, _device(args))


def _stereo_rank(rank: int, world_size: int, args) -> int:
    """One rank of ``stereo --data-parallel`` (a spawn target)."""
    from redtail_tpu_torch.parallel.launch import rank_device

    backend, device_type = ("gloo", "cpu") if args.cpu else ("nccl", "cuda")
    return _train_stereo(args, rank_device(rank, backend, device_type),
                         main=rank == 0)


def _train_stereo(args, device, main: bool = True) -> int:
    from redtail_tpu_torch.data.kitti import KittiStereoDataset
    from redtail_tpu_torch.training.stereo import (StereoTrainConfig,
                                                   train_stereo)

    cfg = StereoTrainConfig(
        model=args.model, crop_hw=_parse_hw(args.crop),
        max_disp=args.max_disp, batch_size=args.batch, steps=args.steps,
        lr=args.lr, warmup_steps=args.warmup, seed=args.seed,
        eval_every=args.eval_every, ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt_dir, resume=args.resume,
        data_parallel=args.data_parallel, dtype=args.dtype)

    dataset = KittiStereoDataset(args.data)
    eval_ds = (KittiStereoDataset(args.eval_data) if args.eval_data
               else dataset)
    state = train_stereo(cfg, dataset, eval_dataset=eval_ds, device=device)

    if args.out and main:
        from redtail_tpu_torch.models.stereo import params_to_numpy
        from redtail_tpu_torch.utils.checkpoint import save_params
        save_params(params_to_numpy(state.params), args.out)
        print(json.dumps({"params": args.out}), flush=True)
    return 0


# --------------------------------------------------------------- trailnet


def _run_trailnet(args) -> int:
    import numpy as np
    import torch

    from redtail_tpu_torch.data.trails import TrailsDataset, build_trail_lists
    from redtail_tpu_torch.models.trailnet import (init_trailnet_params,
                                                   params_to_numpy)
    from redtail_tpu_torch.parallel.training import OptimizerSpec
    from redtail_tpu_torch.training.stereo import (
        warmup_cosine_decay_schedule)
    from redtail_tpu_torch.training.trailnet import make_trailnet_train_step

    device = _device(args)
    splits = build_trail_lists(args.data)
    train_samples = splits.get("train") or sum(splits.values(), [])
    if not train_samples:
        print(f"no samples under {args.data}", file=sys.stderr)
        return 1
    dataset = TrailsDataset(train_samples, seed=args.seed)
    if len(dataset) < args.batch:
        print(f"{len(dataset)} samples < batch {args.batch} "
              "(drop_last yields no batches)", file=sys.stderr)
        return 1

    optimizer = OptimizerSpec("sgd", warmup_cosine_decay_schedule(
        0.0, args.lr, max(1, args.warmup), max(args.steps, args.warmup + 1)),
        momentum=0.9)
    init_fn, step_fn = make_trailnet_train_step(
        optimizer, augment=not args.no_augment, device=device)
    state = init_fn(init_trailnet_params(args.seed))

    gen = torch.Generator().manual_seed(args.seed + 1)
    step_i = 0
    while step_i < args.steps:
        for images, labels in dataset.batches(args.batch):
            if step_i >= args.steps:
                break
            # The IDSIA trail set labels orientation only; the lateral-
            # offset head trains on the same 3-way labels (both heads share
            # topology), as in the JAX app.
            state, metrics = step_fn(state, gen, images, labels, labels)
            step_i += 1
            if step_i % 10 == 0 or step_i == args.steps:
                print(json.dumps({"step": step_i,
                                  "loss": round(float(metrics["loss"]), 5)}),
                      flush=True)

    params = params_to_numpy(state.params)
    if args.out:
        from redtail_tpu_torch.utils.checkpoint import save_params
        save_params(params, args.out)
        print(json.dumps({"params": args.out}), flush=True)
    if args.export_caffe:
        # the reference's own deploy format: prototxt + binary caffemodel
        from redtail_tpu_torch.io.caffe import write_caffemodel
        from redtail_tpu_torch.models.trailnet_proto import (
            emit_trailnet_prototxt, native_params_to_blobs)
        prefix = Path(args.export_caffe)
        prefix.parent.mkdir(parents=True, exist_ok=True)
        prefix.with_suffix(".prototxt").write_text(emit_trailnet_prototxt())
        blobs = native_params_to_blobs(
            {k: {n: np.asarray(a) for n, a in v.items()}
             for k, v in params.items()})
        prefix.with_suffix(".caffemodel").write_bytes(
            write_caffemodel(blobs))
        print(json.dumps({"caffe": str(prefix)}), flush=True)
    return 0


# ------------------------------------------------------------------- main


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="train_app", description=__doc__,
                                formatter_class=argparse.
                                RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("stereo", help="train a stereo disparity model")
    s.add_argument("--model", default="nvtiny",
                   choices=["nvtiny", "nvsmall", "resnet18", "resnet18_2d"])
    s.add_argument("--data", required=True,
                   help="KITTI-2015 or left/right/disp directory")
    s.add_argument("--eval-data", default=None)
    s.add_argument("--crop", default="160x512", help="train crop HxW")
    s.add_argument("--max-disp", type=int, default=None,
                   help="override cost-volume max disparity")
    s.add_argument("--batch", type=int, default=4)
    s.add_argument("--steps", type=int, default=1000)
    s.add_argument("--lr", type=float, default=1e-4)
    s.add_argument("--warmup", type=int, default=100)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--eval-every", type=int, default=0)
    s.add_argument("--ckpt-every", type=int, default=0)
    s.add_argument("--ckpt-dir", default=None)
    s.add_argument("--resume", action="store_true")
    s.add_argument("--data-parallel", type=int, default=1,
                   help="ranks on the data axis: NCCL with a card each, or "
                        "gloo on the CPU with --cpu")
    s.add_argument("--dtype", default="float32",
                   help="conv compute dtype: float32 or bfloat16 (mixed "
                        "precision, fp32 master weights); w8/int8 are "
                        "serving rungs cast from the trained checkpoint")
    s.add_argument("--out", default=None, help="final params .npz")
    s.add_argument("--cpu", action="store_true",
                   help="train on the CPU instead of the card")
    s.set_defaults(fn=_run_stereo)

    t = sub.add_parser("trailnet", help="train TrailNet SResNet-18")
    t.add_argument("--data", required=True, help="trails dataset root")
    t.add_argument("--batch", type=int, default=16)
    t.add_argument("--steps", type=int, default=500)
    t.add_argument("--lr", type=float, default=1e-3)
    t.add_argument("--warmup", type=int, default=50)
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--no-augment", action="store_true")
    t.add_argument("--out", default=None, help="final params .npz")
    t.add_argument("--export-caffe", default=None,
                   help="also export prototxt+caffemodel prefix")
    t.add_argument("--cpu", action="store_true",
                   help="train on the CPU instead of the card")
    t.set_defaults(fn=_run_trailnet)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
