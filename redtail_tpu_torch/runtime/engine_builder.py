"""Offline stereo engine builder (`redtail_tpu/runtime/engine_builder.py`):
builds in a pristine process.

The reference built TensorRT engines once, offline, then deserialized them
everywhere (`sample_app/main.cpp:222-276`); this module is that builder.
`build_stereo_engine` writes the param tree to an npz
(`utils/checkpoint.save_params`), any tree a serving rung runs: float, w8
already dequantized, or int8 with its calibration scales, and runs this
module's CLI in a fresh interpreter, which builds `StereoNet` on the
requested device and dtype and calls `runtime.cache.save_engine`. A fresh
process compiles with nothing of the caller's Inductor state in it, with
one compile thread unless ``TORCHINDUCTOR_COMPILE_THREADS`` says otherwise.

The head is process state in the port (`plain_lowering()`,
`packed3d_lowering()`: context variables), so the caller's is handed over
as ``--lowering``; ``REDTAIL_TPU_PACKED3D`` and ``REDTAIL_TPU_DFOLD`` travel
in the environment. Like JAX's, the head is baked in at trace time, and the
sidecar records which was built.

CLI (what `build_stereo_engine` spawns):
    python -m redtail_tpu_torch.runtime.engine_builder \\
        --model resnet18_2d --hw 321 1025 --max-disp 48 --dtype bf16 \\
        --params params.npz --input-shape 1 161 513 12 --out eng.pt2
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import subprocess
import sys
import tempfile
from pathlib import Path

from redtail_tpu_torch.utils.checkpoint import load_params, save_params

LOWERINGS = ("default", "plain", "packed")


def current_lowering() -> str:
    """The caller's head: ``plain`` inside `plain_lowering()`, ``packed``
    where `use_packed3d()`, else ``default``."""
    from redtail_tpu_torch.ops.convolution import (use_packed3d,
                                                   use_plain_lowering)

    if use_plain_lowering():
        return "plain"
    return "packed" if use_packed3d() else "default"


def build_stereo_engine(path, spec, params, input_shape, *,
                        dtype: str = "bf16", cpu: bool = False,
                        timeout: float = 1800.0, lowering=None):
    """Build and serialize a stereo engine in a pristine subprocess.

    ``params``: the nested param tree of numpy arrays; ``input_shape``: the
    serving input shape of BOTH frames, raw (N, H, W, 3) or s2d-packed
    (N, ceil(H/2), ceil(W/2), 12); ``cpu``: build for the CPU, else the card
    (which must be there); ``lowering``: the head (`LOWERINGS`), by default
    the caller's (`current_lowering`). Returns the builder's summary line
    (the device, the export's and the compile's seconds, the ops, the
    switches); raises with the child's errors where the build fails."""
    lowering = lowering or current_lowering()
    if lowering not in LOWERINGS:
        raise ValueError(f"lowering must be one of {LOWERINGS}, got "
                         f"{lowering!r}")
    with tempfile.TemporaryDirectory() as td:
        pfile = Path(td) / "params.npz"
        save_params(params, pfile)
        cmd = [sys.executable, "-m", "redtail_tpu_torch.runtime.engine_builder",
               "--model", spec.name,
               "--hw", str(spec.input_hw[0]), str(spec.input_hw[1]),
               "--max-disp", str(spec.max_disp),
               "--dtype", dtype,
               "--params", str(pfile),
               "--input-shape", *[str(s) for s in input_shape],
               "--lowering", lowering,
               "--out", str(Path(path).resolve())] + (["--cpu"] if cpu
                                                       else [])
        env = dict(os.environ)
        env.setdefault("TORCHINDUCTOR_COMPILE_THREADS", "1")
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=timeout, env=env,
                           cwd=str(Path(__file__).parents[2]))
        if r.returncode != 0:
            raise RuntimeError(f"engine build failed:\n{r.stderr[-4000:]}")
    return r.stdout.strip().splitlines()[-1]


def main(argv=None):
    ap = argparse.ArgumentParser(description="offline stereo engine builder")
    ap.add_argument("--model", required=True)
    ap.add_argument("--hw", type=int, nargs=2, required=True)
    ap.add_argument("--max-disp", type=int, required=True)
    ap.add_argument("--dtype", default="bf16", choices=["fp32", "bf16"])
    ap.add_argument("--params", required=True)
    ap.add_argument("--input-shape", type=int, nargs=4, required=True)
    ap.add_argument("--lowering", default="default", choices=LOWERINGS)
    ap.add_argument("--out", required=True)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    import torch

    from redtail_tpu_torch import resolve_device
    from redtail_tpu_torch.models import STEREO_SPECS, params_from_numpy
    from redtail_tpu_torch.ops.convolution import (packed3d_lowering,
                                                   plain_lowering)
    from redtail_tpu_torch.runtime.cache import save_engine

    device = resolve_device("cpu" if args.cpu else None)
    spec = dataclasses.replace(STEREO_SPECS[args.model],
                               input_hw=tuple(args.hw),
                               max_disp=args.max_disp)
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    tree = load_params(args.params)
    net = params_from_numpy(spec, tree, device=device, dtype=dtype)
    example = torch.zeros(tuple(args.input_shape), dtype=dtype,
                          device=device)
    lowering = {"default": contextlib.nullcontext, "plain": plain_lowering,
                "packed": packed3d_lowering}[args.lowering]
    with lowering():
        meta = save_engine(args.out, net, example, example, extras={
            "model": args.model, "dtype": args.dtype,
            "input_hw": list(spec.input_hw), "max_disp": spec.max_disp,
            "input_shape": list(args.input_shape),
            "lowering": args.lowering})
    print(f"engine written to {args.out} ({meta['device']}, export "
          f"{meta['export_s']:.1f} s, compile {meta['compile_s']:.1f} s, ops "
          f"{meta['ops']}, switches {meta['switches']}, C++ "
          f"{meta['compiler']})")


if __name__ == "__main__":
    main()
