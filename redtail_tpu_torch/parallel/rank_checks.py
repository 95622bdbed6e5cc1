"""Rank programs that run the multi-device paths on given inputs and hand
the results back to the parent (`launch.spawn_ranks` targets).

The tests and `chip_smoke.py` spawn them: a target must live in a module
of the package, which imports nothing of JAX, for the spawned ranks import
it afresh. Each takes a list of cases, so one spawn runs many; inputs and
results are numpy.

- `mesh_cases`: `sharding.make_mesh` with given sizes: the mesh's shape
  or the error it raised;
- `refused_cases`: a net run inside `sharded_axis` (the correlation model
  under disparity sharding): the error it raised;
- `conv_cases`: one sharded conv or transposed conv (`ops/convolution.py`
  inside `sharded_axis`), its output shard and the gradients of a fixed
  linear loss through it;
- `op_cases`: one op of the 3D heads (the packed ops, dfold, the
  emission) or of `ops/packed2d.py` (no model path calls those) on this
  rank's rows or slots inside an image `sharded_axis`: its output shard;
- `forward_cases`: `sharding.shard_stereo_forward` on global frames under
  a given lowering;
- `train_cases`: one `make_train_step(mesh=)` step on a global batch: the
  metrics, the summed gradients and the params after;
- `run_cases`: forward and train cases in one spawn.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist

from redtail_tpu_torch.parallel.launch import rank_device

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _device(device_type: str) -> torch.device:
    return rank_device(dist.get_rank(), dist.get_backend(), device_type)


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _mesh(meshes: Dict, shape, device: torch.device):
    """The (data, spatial) mesh of ``shape``, made once a spawn (every
    rank makes the same meshes in the same order)."""
    from redtail_tpu_torch.parallel.sharding import make_mesh

    shape = tuple(shape)
    if shape not in meshes:
        meshes[shape] = make_mesh(data=shape[0], spatial=shape[1],
                                  device_type=device.type)
    return meshes[shape]


def _spec(spec: Dict):
    from redtail_tpu_torch.models.stereo import STEREO_SPECS

    base = STEREO_SPECS[spec["name"]]
    return dataclasses.replace(base, **{k: v for k, v in spec.items()
                                        if k != "name"})


def mesh_cases(rank: int, world_size: int, cases: List[Dict],
               device_type: str) -> List[Dict]:
    """Each case: the keyword arguments of `make_mesh`. Returns the mesh's
    (data, spatial) sizes, this rank's coordinates and the axes' names, or
    the error's type and message."""
    from redtail_tpu_torch.parallel.sharding import make_mesh

    out = []
    for kwargs in cases:
        try:
            mesh = make_mesh(device_type=device_type, **kwargs)
        except (ValueError, RuntimeError) as e:
            out.append({"error": type(e).__name__, "message": str(e)})
            continue
        out.append({"shape": (mesh.size(0), mesh.size(1)),
                    "coords": (mesh.get_local_rank(0),
                               mesh.get_local_rank(1)),
                    "names": mesh.mesh_dim_names})
    return out


def refused_cases(rank: int, world_size: int, cases: List[Dict],
                  device_type: str) -> List[Dict]:
    """Each case: ``spec``, ``params``, ``left`` / ``right`` (this rank's
    frames), ``axis`` and ``size``; the net is called inside
    `sharded_axis` over every rank. Returns the error's type and message
    (an empty type if it ran)."""
    from redtail_tpu_torch.models.stereo import params_from_numpy
    from redtail_tpu_torch.ops.halo import sharded_axis

    device = _device(device_type)
    out = []
    for c in cases:
        net = params_from_numpy(_spec(c["spec"]), c["params"], device=device)
        left, right = (torch.from_numpy(c[k]).to(device)
                       for k in ("left", "right"))
        try:
            with torch.no_grad(), sharded_axis(None, c["axis"], c["size"]):
                net(left, right)
            out.append({"error": "", "message": ""})
        except ValueError as e:
            out.append({"error": type(e).__name__, "message": str(e)})
    return out


def conv_cases(rank: int, world_size: int, cases: List[Dict],
               device_type: str) -> List[Dict]:
    """Each case: ``x`` the global NCHW / NCDHW input, ``w`` the weight
    (OIHW, or (in, out, *k) for ``transposed``), ``stride``, ``axis`` (-2
    or -3), ``g`` the loss weights over the global output (the loss is
    sum(out * g)), ``out_spatial`` for a transposed conv. Returns this
    rank's output rows, its rows of dL/dx and its part of dL/dw."""
    from redtail_tpu_torch.ops import convolution as conv
    from redtail_tpu_torch.ops.halo import shard, sharded_axis

    device = _device(device_type)
    out = []
    for c in cases:
        axis = c["axis"]
        x = shard(torch.from_numpy(c["x"]), axis, world_size, rank)
        x = x.to(device).requires_grad_(True)
        w = torch.from_numpy(c["w"]).to(device).requires_grad_(True)
        nd = x.dim() - 2
        with sharded_axis(None, axis, c["x"].shape[axis]):
            if c.get("transposed"):
                y = conv._conv_transpose(x, w, None, c["out_spatial"],
                                         c["stride"], "SAME")
            else:
                y = conv._conv(x, w, None, (c["stride"],) * nd, "SAME")
        g = shard(torch.from_numpy(c["g"]), axis, world_size, rank)
        (y.float() * g.to(device)).sum().backward()
        out.append({"y": _numpy(y), "dx": _numpy(x.grad),
                    "dw": _numpy(w.grad) if w.grad is not None
                    else np.zeros(c["w"].shape, np.float32)})
    return out


def _ops():
    from redtail_tpu_torch.ops import packed2d as P2
    from redtail_tpu_torch.ops import packed3d as P
    from redtail_tpu_torch.ops.convolution import conv3d_transpose_dfold
    from redtail_tpu_torch.ops.fused_cost_volume_conv import \
        cost_volume_conv3d

    return {"conv1_s2d_hpacked": P2.conv1_s2d_hpacked,
            "conv2d_hpacked": P2.conv2d_hpacked,
            "conv2d_hpacked_keep": P2.conv2d_hpacked_keep,
            "unpack_h2d": P2.unpack_h2d,
            "corr_softargmax_hpacked": P2.corr_softargmax_hpacked,
            "conv3d_packed": P.conv3d_packed,
            "conv3d_packed_down": P.conv3d_packed_down,
            "conv3d_packed_down_unpack": P.conv3d_packed_down_unpack,
            "deconv3d_packed": P.deconv3d_packed,
            "unpack_conv": P.unpack_conv,
            "conv3d_transpose_dfold": conv3d_transpose_dfold,
            "cost_volume_conv3d": cost_volume_conv3d}


def op_kwargs(kwargs: Dict) -> Dict:
    """A case's keyword arguments with the named functions resolved
    (``act="elu"``, ``reduce="softargmin"``, the soft-argmin over the
    trailing D of dfold's 'dlast' output)."""
    from redtail_tpu_torch.ops.activations import elu
    from redtail_tpu_torch.ops.softargmax import softargmin

    named = {"elu": elu,
             "softargmin": lambda t: softargmin(t[..., 0], axis=-1)}
    return {k: named[v] if k in ("act", "reduce") and v is not None else v
            for k, v in kwargs.items()}


def op_cases(rank: int, world_size: int, cases: List[Dict],
             device_type: str) -> List[Dict]:
    """Each case: ``op`` (a name of `_ops`), ``args`` (its positional
    arguments, numpy or None), ``sharded`` (the indices of the arguments
    whose ``axis`` the ranks split: global inputs here) and ``kwargs``;
    the op runs on this rank's shards inside an image `sharded_axis` of
    the sharded inputs' global size. Returns this rank's output."""
    from redtail_tpu_torch.ops.halo import IMAGE_AXIS, shard, sharded_axis

    device = _device(device_type)
    out = []
    for c in cases:
        args = [None if a is None else torch.from_numpy(a) for a in c["args"]]
        size = args[c["sharded"][0]].shape[c["axis"]]
        args = [(shard(a, c["axis"], world_size, rank)
                 if i in c["sharded"] else a) for i, a in enumerate(args)]
        args = [None if a is None else a.to(device) for a in args]
        with torch.no_grad(), sharded_axis(None, IMAGE_AXIS, size):
            y = _ops()[c["op"]](*args, **op_kwargs(c["kwargs"]))
        out.append({"y": _numpy(y)})
    return out


@contextlib.contextmanager
def lowering(name: str):
    """The 3D head a case runs, on the unsharded and the sharded forward
    alike: ``"fused"`` (the default), ``"plain"``, ``"packed"`` (its final
    deconv the unpack branch on the CPU, dfold on the card) or
    ``"packed+dfold"`` (dfold on the CPU too, through
    ``REDTAIL_TPU_DFOLD``, which has no context form); the switches are
    set for the block and restored after. ``"fused"`` raises where the
    environment selects the packed head (``REDTAIL_TPU_PACKED3D=1``)."""
    from redtail_tpu_torch.ops.convolution import (packed3d_lowering,
                                                   plain_lowering,
                                                   use_packed3d)

    if name not in LOWERINGS:
        raise ValueError(f"lowering must be one of {LOWERINGS}, got "
                         f"{name!r}")
    if name == "fused" and use_packed3d():
        raise ValueError("REDTAIL_TPU_PACKED3D=1 selects the packed head; "
                         "the fused case needs it unset or 0")
    saved = os.environ.get("REDTAIL_TPU_DFOLD")
    os.environ["REDTAIL_TPU_DFOLD"] = "1" if name == "packed+dfold" else "0"
    try:
        with (plain_lowering() if name == "plain"
              else packed3d_lowering() if name.startswith("packed")
              else contextlib.nullcontext()):
            yield
    finally:
        if saved is None:
            os.environ.pop("REDTAIL_TPU_DFOLD", None)
        else:
            os.environ["REDTAIL_TPU_DFOLD"] = saved


LOWERINGS = ("fused", "plain", "packed", "packed+dfold")


def forward_cases(rank: int, world_size: int, cases: List[Dict],
                  device_type: str) -> List[Dict]:
    """Each case: ``spec`` (a `STEREO_SPECS` name and replaced fields),
    ``params`` (numpy tree), ``left`` / ``right`` (global frames),
    ``mesh`` (data, spatial), ``mode``, ``dtype``, ``lowering`` (see
    `lowering`; default ``"fused"``); a disparity-mode case ignores
    ``lowering``: its head is the plain one (`plain_volume_head`). With
    ``unsharded`` rank 0 runs the same net on the whole frames instead,
    under the same ``lowering`` (under `plain_volume_head` where the case's
    ``mode`` is ``"disparity"``) and on the same route: with no kernel form
    for the 3D encoder's conv + ELU or the 3D decoder's transposed conv,
    which a sharded forward never takes (`ops/convolution.py:
    conv3d_k3_routes`, `deconv3d_s2_routes`); the other ranks return None.
    Returns the disparity (gathered), the launches in this rank of the
    correlation kernel's soft-argmax (``corr``), concat, emission (``emit``:
    both layouts; ``packed_emit``: the dh-shifted one), conv223 and
    transposed conv (``deconv``: none, a sharded forward never takes it)
    kernels, the bytes its halo exchanges received and the bytes of the
    activations they were called on, peak device memory, and the device
    time of one forward on the card (CUDA events; 0 on the CPU)."""
    from redtail_tpu_torch.kernels import conv223
    from redtail_tpu_torch.kernels import corr_cost_volume as corr
    from redtail_tpu_torch.kernels import cost_volume_concat as concat
    from redtail_tpu_torch.kernels import deconv3d_s2
    from redtail_tpu_torch.kernels import fused_cv_emit as emit
    from redtail_tpu_torch.models.stereo import (params_from_numpy,
                                                 plain_volume_head)
    from redtail_tpu_torch.ops.halo import exchange
    from redtail_tpu_torch.parallel.sharding import shard_stereo_forward

    counters = {"corr_launches": (corr.corr_softargmax, "launches"),
                "concat_launches": (concat.cost_volume_concat, "launches"),
                "emit_launches": (emit.fused_cv_emit, "launches"),
                "packed_emit_launches": (emit.fused_cv_emit,
                                         "packed_launches"),
                "conv223_launches": (conv223.conv223, "launches"),
                "deconv_launches": (deconv3d_s2.deconv3d_s2, "launches"),
                "moved_bytes": (exchange, "moved"),
                "held_bytes": (exchange, "held")}
    device = _device(device_type)
    meshes = {}
    out = []
    for c in cases:
        spec = _spec(c["spec"])
        dtype = DTYPES[c.get("dtype", "float32")]
        mode = c.get("mode", "image")
        head = "fused" if mode == "disparity" else c.get("lowering", "fused")
        if c.get("unsharded") and rank:
            out.append(None)
            continue
        net = params_from_numpy(spec, c["params"], device=device,
                                dtype=dtype)
        if c.get("unsharded"):
            for layer in net.modules():
                for form in ("kernel_kc", "kernel_s2"):
                    if getattr(layer, form, None) is not None:
                        setattr(layer, form, None)

            def fn(_, left, right, net=net, disparity=mode == "disparity"):
                with torch.no_grad(), (plain_volume_head() if disparity
                                       else contextlib.nullcontext()):
                    return net(left, right)
        else:
            fn = shard_stereo_forward(spec, net,
                                      _mesh(meshes, c["mesh"], device),
                                      mode=mode)
        left, right = (torch.from_numpy(c[k]).to(device, dtype)
                       for k in ("left", "right"))
        with lowering(head):
            if device.type == "cuda":
                fn(None, left, right)  # warm-up: kernels loaded, caches
                torch.cuda.synchronize(device)
                torch.cuda.reset_peak_memory_stats(device)
            before = {k: getattr(*v) for k, v in counters.items()}
            disp = fn(None, left, right)
            res = {k: getattr(*v) - before[k] for k, v in counters.items()}
            res.update(disp=_numpy(disp), ms=0.0, peak_bytes=(
                torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0))
            if device.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn(None, left, right)
                end.record()
                end.synchronize()
                res["ms"] = start.elapsed_time(end)
        out.append(res)
    return out


def train_cases(rank: int, world_size: int, cases: List[Dict],
                device_type: str) -> List[Dict]:
    """Each case: ``spec``, ``params`` (numpy tree), ``batch`` (left,
    right, target, valid: global numpy arrays), ``mesh`` (data, spatial),
    ``dtype`` (the compute dtype); with ``unsharded`` rank 0 takes the
    step without a mesh and the other ranks return None. One
    `make_train_step` step with Adam at 1e-4; returns the loss, the EPE,
    the (summed) gradient tree, the params after the step and the
    launches of the volume kernels and their backwards in this rank."""
    from redtail_tpu_torch.kernels import corr_cost_volume as corr
    from redtail_tpu_torch.kernels import cost_volume_concat as concat
    from redtail_tpu_torch.models.stereo import params_to_numpy
    from redtail_tpu_torch.parallel.training import make_train_step

    counters = {"corr_softargmax": corr.corr_softargmax,
                "corr_softargmax_bwd": corr.corr_softargmax_bwd,
                "cost_volume_concat": concat.cost_volume_concat,
                "cost_volume_concat_bwd": concat.cost_volume_concat_bwd}
    device = _device(device_type)
    meshes = {}
    out = []
    for c in cases:
        mesh = None
        if c.get("unsharded"):
            if rank:
                out.append(None)
                continue
        else:
            mesh = _mesh(meshes, c["mesh"], device)
        spec = _spec(c["spec"])
        dtype = DTYPES[c.get("dtype", "float32")]
        init_fn, step_fn = make_train_step(
            spec, mesh=mesh, device=device,
            compute_dtype=None if dtype == torch.float32 else dtype)
        state = init_fn(c["params"])
        before = {k: f.launches for k, f in counters.items()}
        state, metrics = step_fn(state, *c["batch"])
        out.append({"loss": float(metrics["loss"]),
                    "epe": float(metrics["epe"]),
                    "grads": params_to_numpy(state.params, grads=True),
                    "params": params_to_numpy(state.params),
                    "launches": {k: f.launches - before[k]
                                 for k, f in counters.items()}})
    return out


def run_cases(rank: int, world_size: int, groups: Dict[str, List[Dict]],
              device_type: str) -> Dict[str, List[Dict]]:
    """Several programs in one spawn: ``groups`` maps ``'forward'``,
    ``'train'`` and ``'op'`` to their cases."""
    programs = {"forward": forward_cases, "train": train_cases,
                "op": op_cases}
    return {name: programs[name](rank, world_size, cases, device_type)
            for name, cases in groups.items()}
