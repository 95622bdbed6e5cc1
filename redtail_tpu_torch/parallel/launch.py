"""Start the ranks of a multi-device run (no counterpart in the JAX package,
which is one controller over many devices; here each rank is a process).

`spawn_ranks(fn, world_size, backend=..., device_type=...)` runs
``fn(rank, world_size, *args)`` in ``world_size`` processes started with
the spawn method, each with the default process group initialized over a
``file://`` store in a temporary directory (no port, no network), and
returns the ranks' return values in rank order. An exception in any rank
fails the call with that rank's traceback.

The backend is the caller's choice and nothing changes it: ``"nccl"`` gives
each rank a card of its own (``cuda:rank``), ``"gloo"`` runs the ranks on
the CPU (``device_type="cpu"``) or on one shared card (``cuda:0``). Gloo
takes CUDA tensors for the collectives the port uses (``all_gather``,
``all_reduce``, ``broadcast``).

`init_from_env()` joins a group started by ``torchrun`` (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``).

``fn`` must be importable by the children: a function of a module that
imports nothing of JAX (the spawned process imports its module afresh).
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
from pathlib import Path
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

BACKENDS = ("nccl", "gloo")
DEVICE_TYPES = ("cpu", "cuda")


def rank_device(rank: int, backend: str, device_type: str) -> torch.device:
    """The device rank ``rank`` computes on: the CPU, its own card under
    NCCL, or card 0, shared, under gloo."""
    if device_type == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", rank if backend == "nccl" else 0)


def check_launch(world_size: int, backend: str, device_type: str) -> None:
    """Raise before anything starts where the ranks cannot run."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if device_type not in DEVICE_TYPES:
        raise ValueError(f"device_type must be one of {DEVICE_TYPES}, got "
                         f"{device_type!r}")
    if world_size < 1:
        raise ValueError(f"world_size must be >= 1, got {world_size}")
    if backend == "nccl" and device_type != "cuda":
        raise ValueError("nccl runs CUDA ranks only")
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available: pass "
                               "device_type='cpu' for ranks on the CPU")
        need = world_size if backend == "nccl" else 1
        if torch.cuda.device_count() < need:
            raise RuntimeError(
                f"{world_size} nccl ranks need {need} cards, one each; only "
                f"{torch.cuda.device_count()} visible")


def _rank_main(rank: int, fn: Callable, world_size: int, backend: str,
               device_type: str, store: str) -> None:
    with open(f"{store}/args.pkl", "rb") as f:
        args = pickle.load(f)
    device = rank_device(rank, backend, device_type)
    if device.type == "cpu":
        # oversubscribed CPU convs run several times slower
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"file://{store}/rendezvous",
                            rank=rank, world_size=world_size)
    try:
        out = fn(rank, world_size, *args)
        with open(f"{store}/result{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn: Callable, world_size: int, *, backend: str,
                device_type: str, args: Sequence = ()) -> List[Any]:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` spawned
    processes (see the module docstring); returns their return values
    (pickled back) in rank order."""
    check_launch(world_size, backend, device_type)
    store = tempfile.mkdtemp(prefix="redtail_ranks_")
    try:
        # the arguments travel in a file: through the spawn's own pipe a
        # megabyte of numpy took seconds a rank
        with open(f"{store}/args.pkl", "wb") as f:
            pickle.dump(tuple(args), f)
        mp.spawn(_rank_main, args=(fn, world_size, backend, device_type,
                                   store),
                 nprocs=world_size, join=True, start_method="spawn")
        results = []
        for rank in range(world_size):
            with open(Path(store) / f"result{rank}.pkl", "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        shutil.rmtree(store, ignore_errors=True)


def init_from_env(backend: str, device_type: str = "cuda") -> torch.device:
    """Join the process group a launcher such as ``torchrun`` set up in the
    environment; returns this rank's device (`rank_device`, by
    ``LOCAL_RANK`` under NCCL)."""
    world_size = int(os.environ["WORLD_SIZE"])
    check_launch(world_size, backend, device_type)
    local = int(os.environ.get("LOCAL_RANK", os.environ["RANK"]))
    device = rank_device(local, backend, device_type)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method="env://")
    return device
