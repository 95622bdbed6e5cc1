"""Meshes and sharded stereo forwards (`redtail_tpu/parallel/sharding.py`).

Axis conventions, as in the JAX package:

- ``data``: the batch (data parallelism; the gradients are summed over the
  mesh, `parallel/training.py`);
- ``spatial``: the image H (image mode) or, for the 3D cost-volume models'
  inference, the disparity D (disparity mode).

JAX is one controller over many devices and GSPMD inserts the collectives.
Here each rank is a process (`parallel/launch.py`), the mesh is a
`torch.distributed.device_mesh.DeviceMesh` over the default process group,
a layout is a tuple of DTensor placements (`Shard`, `Replicate`), one per
mesh axis, and each rank computes on its own local shard
(`local_shard`, the ownership rule of `ops/halo.py`). The few
collectives the stereo nets need are the port's own: the halo exchanges
of the convs, of the packed head's slot-axis ops and of the emission
(`ops/halo.py:sharded_axis`), the soft-argmin's normalization over a
sharded D (`ops/softargmax.py`) and the gathers of the output.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Placement, Replicate, Shard

from redtail_tpu_torch.models.stereo import (StereoNet, StereoSpec,
                                             plain_volume_head)
from redtail_tpu_torch.ops import halo
from redtail_tpu_torch.ops.halo import (DISPARITY_AXIS, IMAGE_AXIS,
                                       sharded_axis)

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"
MODES = ("image", "disparity")


def make_mesh(*, data: Optional[int] = None, spatial: Optional[int] = None,
              device_type: Optional[str] = None) -> DeviceMesh:
    """A (data, spatial) mesh over the ranks of the initialized default
    process group (`parallel/launch.py`).

    Defaults as in the JAX package: every rank on ``data`` if no size is
    given, else the missing size derived; the product must be the number
    of ranks. ``device_type``: ``None`` is the card (``"cuda"``), or
    ``"cpu``"."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: start the ranks with "
                           "parallel.launch.spawn_ranks or init_from_env")
    n = dist.get_world_size()
    if data is None and spatial is None:
        data, spatial = n, 1
    elif data is None:
        data = n // spatial
    elif spatial is None:
        spatial = n // data
    if data * spatial != n:
        raise ValueError(f"mesh {data}x{spatial} != {n} devices")
    device_type = device_type or "cuda"
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device_type='cpu' "
                           "for a mesh of CPU ranks")
    return init_device_mesh(device_type, (data, spatial),
                            mesh_dim_names=(DATA_AXIS, SPATIAL_AXIS))


def batch_sharding(mesh: DeviceMesh, *, spatial_dim: Optional[int] = 1
                   ) -> tuple:
    """Placements of NHWC image batches: N over data, H (``spatial_dim``)
    over spatial, or replicated over spatial for ``spatial_dim=None``."""
    del mesh
    return (Shard(0), Replicate() if spatial_dim is None
            else Shard(spatial_dim))


def replicate(mesh: DeviceMesh) -> tuple:
    """Placements of a tensor every rank holds whole."""
    del mesh
    return (Replicate(), Replicate())


def local_shard(mesh: DeviceMesh, x, placements: Sequence[Placement]):
    """This rank's shard of the global array ``x`` (numpy or tensor) under
    ``placements``, cut by the ownership rule of `ops/halo.py`."""
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            lo, hi = halo.owned(x.shape[p.dim], mesh.size(i),
                                mesh.get_local_rank(i))
            x = x[(slice(None),) * p.dim + (slice(lo, hi),)]
    return x


def check_batch(mesh: DeviceMesh, n: int) -> None:
    """Raise where a global batch of ``n`` does not split evenly over the
    mesh's data axis."""
    if n % mesh.size(0):
        raise ValueError(f"batch {n} does not divide over the data axis's "
                         f"{mesh.size(0)} ranks")


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on ``mesh``: the CPU, or for a CUDA mesh the card
    current in this rank (`parallel/launch.py` makes each rank's card
    current)."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _on_mesh(a, device: torch.device) -> torch.Tensor:
    """A frame on the mesh's device: numpy is put there; a tensor on
    another kind of device raises (nothing moves it behind the caller's
    back)."""
    if isinstance(a, np.ndarray):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)
    if a.device.type != device.type:
        raise ValueError(f"a frame on {a.device} for a mesh on "
                         f"{device.type}")
    return a


def _gather(mesh: DeviceMesh, out: torch.Tensor, axis: int, mesh_dim: int,
            global_size: int) -> torch.Tensor:
    if mesh.size(mesh_dim) == 1:
        return out
    return halo.gather(out, axis=axis, global_size=global_size,
                       group=mesh.get_group(mesh_dim))


def shard_stereo_forward(spec: StereoSpec, params, mesh: DeviceMesh, *,
                         mode: str = "image"):
    """The stereo forward sharded over the mesh: ``fn(params, left, right)
    -> (N, H, W)`` disparity, which every rank calls with the global frames
    (raw ``(N, H, W, 3)`` or s2d ``(N, ceil(H/2), ceil(W/2), 12)``, numpy
    or tensors) and gets back whole, on the mesh's device (`mesh_device`:
    numpy frames are put there, tensors on another kind of device raise).
    ``params``: a `StereoNet` for ``spec`` on the mesh's device, or the
    numpy param tree (built per call on the mesh's device in the frames'
    dtype, as `stereo_forward` does); the one given here is the
    default.

    - ``mode='image'``: N over data, H over spatial, params replicated;
      each rank computes its own rows of H plus the halos its convs
      fetch. The towers run as one batch of 2N. ResNet18-2D runs the
      correlation kernel's fused soft-argmax on each rank's rows
      (row-local); the 3D models run the head the
      lowering in force selects, as the unsharded `StereoNet` does: the
      fused cost volume + conv3D_1 (the emission kernel on each rank's
      rows) by default, the packed head on each rank's slots (the
      emission's dh-shifted layout, conv223, the D-folded final deconv on
      the card or with ``REDTAIL_TPU_DFOLD=1``) under
      `packed3d_lowering()` / ``REDTAIL_TPU_PACKED3D=1``, the explicit
      concat volume under `plain_lowering()`. Int8 leaves run sharded.
    - ``mode='disparity'`` (3D models only): the images split over data
      only; each spatial rank runs the towers on the whole frames (a 2D
      map has no D axis: they run unsharded), as the JAX package's
      `_encode_pair` does; then, under
      `plain_lowering()` whatever the caller's (`plain_volume_head`), it
      builds its own disparities of the concat volume
      (`cost_volume_concat(d_offset=...)`) and runs the unpacked 3D stack
      on them with D halos (as the JAX package's disparity mode); the
      soft-argmin's normalization is the one cross-D reduction. The (D,
      H, W, 2C) volume, the memory peak, is split over the ranks."""
    if mode not in MODES:
        raise ValueError(f"unknown sharding mode {mode!r}")
    if mode == "disparity" and spec.corr:
        raise ValueError("disparity sharding applies to the 3D "
                         "cost-volume models")
    spatial = mesh.size(1)
    img = batch_sharding(mesh, spatial_dim=1 if mode == "image" else None)
    default = params

    def fn(params, left, right):
        params = default if params is None else params
        device = mesh_device(mesh)
        if isinstance(params, StereoNet):
            if params.spec != spec:
                raise ValueError(f"params were built for {params.spec}, "
                                 f"not {spec}")
            if params.device.type != device.type:
                raise ValueError(f"params on {params.device} for a mesh "
                                 f"on {device.type}")
        left, right = (_on_mesh(a, device) for a in (left, right))
        check_batch(mesh, left.shape[0])
        full_h = spec.input_hw[0] if left.shape[-1] == 12 else left.shape[1]
        rows = left.shape[1]
        net = params if isinstance(params, StereoNet) else StereoNet(
            spec, params, device=device, dtype=left.dtype)
        lo, ro = (local_shard(mesh, a, img).contiguous()
                  for a in (left, right))
        with contextlib.ExitStack() as stack:
            stack.enter_context(torch.no_grad())
            if mode == "disparity":
                stack.enter_context(plain_volume_head())
            if spatial > 1:
                axis, size = ((IMAGE_AXIS, rows) if mode == "image"
                              else (DISPARITY_AXIS, spec.max_disp))
                stack.enter_context(sharded_axis(
                    mesh.get_group(SPATIAL_AXIS), axis, size))
            out = net(lo, ro)
            if mode == "image":
                out = _gather(mesh, out, 1, 1, full_h)
            return _gather(mesh, out, 0, 0, left.shape[0])

    return fn
