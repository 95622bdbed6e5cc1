"""Train the real TrailNet SResNet-18 on rendered trail views
(`tools/train_trailnet_synth.py`), on the card unless ``--cpu``.

`apps.sim_app.sample_labeled_view` renders labeled camera views (pose
sampled per class, the controller law's conventions);
`training.trailnet.make_trailnet_train_step` trains the native TrailNet on
them with SGD (momentum 0.9) under optax's warmup-cosine schedule; a
held-out accuracy gate (a fresh ``RandomState(seed + 1000)`` stream) guards
convergence; the weights are saved as the per-channel int8 artifact
(`models.trailnet.params_to_w8_npz`) that `sim_app --real-dnn --weights`
loads to close the loop with the real network. A failed gate exits 1 and
writes nothing. The init is the port's (`init_trailnet_params`, a torch
generator), not `jax.random`'s, so a run reaches the committed
artifact's gate (`tests/data/trailnet_synth_trained.npz`, made by the JAX
tool), not its bits. Imports nothing of JAX.

Usage:
  python -m redtail_tpu_torch.apps.train_trailnet_synth
  python -m redtail_tpu_torch.apps.sim_app --real-dnn \\
      --weights redtail_tpu_torch/build/trailnet_synth_trained.npz
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

# Not tests/data/: the committed artifact there is the JAX tool's, and a
# run of this tool must not overwrite it.
DEFAULT_OUT = (Path(__file__).resolve().parents[1] / "build"
               / "trailnet_synth_trained.npz")


def render_batch(trail, rng, n, hw=(180, 320)):
    """``n`` labeled views: (n, H, W, 3) float32 0-255 images, (n,) view
    and (n,) side classes, int32."""
    from redtail_tpu_torch.apps.sim_app import sample_labeled_view

    imgs, views, sides = [], [], []
    for _ in range(n):
        img, v, s = sample_labeled_view(trail, rng, hw=hw)
        imgs.append(img)
        views.append(v)
        sides.append(s)
    return (np.stack(imgs), np.asarray(views, np.int32),
            np.asarray(sides, np.int32))


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--out", default=str(DEFAULT_OUT),
                    help="where the w8 artifact goes (default under the "
                         "package's build/, which git ignores; not "
                         "tests/data/, whose committed artifact this run "
                         "must not overwrite)")
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eval-n", type=int, default=96)
    ap.add_argument("--acc-gate", type=float, default=0.9,
                    help="held-out per-head accuracy both heads must reach")
    ap.add_argument("--cpu", action="store_true",
                    help="train and evaluate on the CPU instead of the card")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    return run(parse_args(argv))


def train(args: argparse.Namespace, init_params=None):
    """``args.steps`` SGD steps on freshly rendered batches from
    ``init_params`` (a native numpy tree, the JAX package's say), or the
    port's seeded init. Returns (state, the per-step losses as 0-d
    tensors)."""
    import torch

    from redtail_tpu_torch.apps.sim_app import Trail
    from redtail_tpu_torch.models.trailnet import init_trailnet_params
    from redtail_tpu_torch.parallel.training import OptimizerSpec
    from redtail_tpu_torch.training.stereo import \
        warmup_cosine_decay_schedule
    from redtail_tpu_torch.training.trailnet import make_trailnet_train_step

    trail = Trail()
    rng = np.random.RandomState(args.seed)
    optimizer = OptimizerSpec(
        "sgd", warmup_cosine_decay_schedule(0.0, args.lr,
                                            max(1, args.steps // 10),
                                            args.steps),
        momentum=0.9)
    # augment=False: the renderer already varies pose/noise per sample,
    # and the geometric augs (rotate/crop) would blur the class-defining
    # yaw/offset geometry near thresholds.
    init_fn, step_fn = make_trailnet_train_step(
        optimizer, augment=False, device="cpu" if args.cpu else None)
    state = init_fn(init_trailnet_params(args.seed) if init_params is None
                    else init_params)
    gen = torch.Generator().manual_seed(args.seed + 1)  # augment: never read
    losses = []
    for step_i in range(1, args.steps + 1):
        imgs, views, sides = render_batch(trail, rng, args.batch)
        state, metrics = step_fn(state, gen, imgs, views, sides)
        losses.append(metrics["loss"])
        if step_i % 20 == 0 or step_i == args.steps:
            print(json.dumps({"step": step_i,
                              "loss": round(float(metrics["loss"]), 5)}),
                  flush=True)
    return state, losses


def heldout_accuracy(net, seed: int, eval_n: int, batch: int):
    """(view, side) accuracy of the `TrailNet` ``net`` on ``eval_n`` views
    from a fresh ``RandomState(seed + 1000)`` stream, in batches of
    ``batch``."""
    import torch

    from redtail_tpu_torch.apps.sim_app import Trail

    trail = Trail()
    eval_rng = np.random.RandomState(seed + 1000)
    hits_v = hits_s = 0
    for i in range(0, eval_n, batch):
        n = min(batch, eval_n - i)
        imgs, views, sides = render_batch(trail, eval_rng, n)
        with torch.inference_mode():
            probs = net(torch.from_numpy(imgs).to(net.device))
        probs = probs.float().cpu().numpy()
        hits_v += int((probs[:, :3].argmax(-1) == views).sum())
        hits_s += int((probs[:, 3:].argmax(-1) == sides).sum())
    return hits_v / eval_n, hits_s / eval_n


def run(args: argparse.Namespace, init_params=None) -> int:
    """The tool on parsed ``args``; ``init_params`` as in `train`."""
    from redtail_tpu_torch.models.trailnet import params_to_w8_npz

    state, _ = train(args, init_params)
    acc_v, acc_s = heldout_accuracy(state.params, args.seed, args.eval_n,
                                    args.batch)
    print(json.dumps({"eval_view_acc": round(acc_v, 4),
                      "eval_side_acc": round(acc_s, 4)}), flush=True)
    if min(acc_v, acc_s) < args.acc_gate:
        print(json.dumps({"error": "accuracy gate failed",
                          "gate": args.acc_gate}))
        return 1

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    params_to_w8_npz(state.params, out)
    print(json.dumps({"params": str(out), "bytes": out.stat().st_size}),
          flush=True)
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
