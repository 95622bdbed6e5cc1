"""Persistent compilation cache and serialized engines
(`redtail_tpu/runtime/cache.py`), the counterpart of the reference's
TensorRT plan files.

The reference serialized built engines to `.plan` files to cut model load
from minutes to under a second (`sample_app/main.cpp:198-276`). The port's
engine is an AOTInductor package: `torch.export` traces the model (the four
CUDA kernels as the `redtail_torch::` custom ops of `kernels/_ops.py`),
Inductor compiles the graph ahead of time with the weights inside as
constants, and a fresh process loads the package with neither the weights
nor the model code (`load_engine` imports `kernels._ops` and nothing of
`models/`).

Beside each package a JSON sidecar (``<path>.json``) records what the
graph cannot hold:

- the device type and the card's name: `load_engine` refuses another
  (engines are device-specific, as plan files are);
- the conv numerics switches: the eager convs set cuDNN's and cuBLAS's
  TF32 switches and cuDNN's determinism around each launch
  (`ops/convolution.py:_tf32`), Python side effects the exported graph
  drops. The trace records each conv's setting (`record_switches`) and
  the engine's call sets them (TF32 only where every conv allowed it)
  under `_FLAGS_LOCK`, so an fp32 engine does not silently run in TF32;
- the torch version, the export's and the compile's seconds, the C++
  compiler (`cpp_compiler`), and the builder's ``extras`` (model, dtype,
  sizes, input form, head).

Inductor compiles with ``emulate_precision_casts``: the port's bf16 convs
run on fp32 carriers and round once on purpose, and without the setting
Inductor folds a bf16 round trip (`.to(bfloat16).float()`) that eager
takes into a plain fp32 value.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import platform
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, Optional

import torch

from redtail_tpu_torch import resolve_device

DEFAULT_CACHE_DIR = os.environ.get(
    "REDTAIL_TPU_CACHE",
    str(Path.home() / ".cache" / "redtail_tpu_torch" / "inductor"))
# Inductor settings of every engine build (see the module docstring).
INDUCTOR_CONFIGS = {"emulate_precision_casts": True}
SIDECAR = ".json"


def device_key(device) -> str:
    """The cache's subdirectory for ``device``: the card's name, or for
    the CPU a hash of the host's CPU flags (Inductor's CPU code embeds the
    host's ISA features, so entries written on another host must not
    load here: the JAX module's reason, `redtail_tpu/runtime/cache.py`)."""
    device = torch.device(device)
    if device.type == "cuda":
        return re.sub(r"[^A-Za-z0-9]+", "_",
                      torch.cuda.get_device_name(device)).strip("_")
    try:
        with open("/proc/cpuinfo") as f:
            flags = next(line for line in f if line.startswith("flags"))
    except (OSError, StopIteration):
        flags = platform.processor() or "unknown"
    return "cpu-" + hashlib.sha1(flags.encode()).hexdigest()[:12]


def enable_compilation_cache(cache_dir: Optional[str] = None,
                             device=None) -> str:
    """Point Inductor's persistent caches (FX graphs, AOT autograd, Triton
    kernels) at ``<cache_dir>/<device_key>`` for ``device`` (None: the
    card, see `resolve_device`) and turn the FX-graph cache on. The
    directory goes in ``TORCHINDUCTOR_CACHE_DIR``, so a builder subprocess
    shares it. Idempotent; returns the directory."""
    import torch._inductor.config as inductor_config

    path = Path(cache_dir or DEFAULT_CACHE_DIR) / device_key(
        resolve_device(device))
    path.mkdir(parents=True, exist_ok=True)
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(path)
    inductor_config.fx_graph_cache = True
    return str(path)


class _Call(torch.nn.Module):
    """A callable as the module `torch.export` takes."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _export(fn, example_args):
    """`torch.export.export` under inference mode. An example tensor passed
    twice (one zero frame for both sides) is copied: export would take the
    two inputs for one and feed both from the first."""
    module = fn if isinstance(fn, torch.nn.Module) else _Call(fn)
    args, seen = [], set()
    for a in example_args:
        if isinstance(a, torch.Tensor):
            if id(a) in seen:
                a = a.clone()
            seen.add(id(a))
        args.append(a)
    with torch.inference_mode():
        return torch.export.export(module, tuple(args))


def _device_of(example_args) -> torch.device:
    devices = {a.device for a in example_args if isinstance(a, torch.Tensor)}
    if len(devices) != 1:
        raise ValueError(f"the example inputs must lie on one device; got "
                         f"{sorted(map(str, devices))}")
    return devices.pop()


def openmp_compiles(compiler: str) -> bool:
    """Whether ``compiler`` builds a shared object with ``-fopenmp``."""
    try:
        r = subprocess.run(
            [compiler, "-fopenmp", "-shared", "-fPIC", "-x", "c++", "-",
             "-o", os.devnull], input="int f() { return 0; }\n",
            capture_output=True, text=True, timeout=120)
    except OSError:
        return False
    return r.returncode == 0


def cpp_compiler() -> str:
    """The C++ compiler of an engine build: Inductor's own choice (``CXX``,
    else g++), which compiles with ``-fopenmp``; where that one cannot
    build OpenMP (a toolchain without libgomp), the g++ on ``PATH`` (the
    one `native.py` and nvcc use, built against the system's libstdc++),
    set as Inductor's compiler. Raises where neither can."""
    from torch._inductor import config as inductor_config
    from torch._inductor import cpp_builder

    chosen = cpp_builder.get_cpp_compiler()
    if openmp_compiles(chosen):
        return chosen
    system = shutil.which("g++")
    if system is None or not openmp_compiles(system):
        raise RuntimeError(f"no C++ compiler here builds OpenMP, which an "
                           f"engine's C++ needs: {chosen} does not, and the "
                           f"g++ on PATH is {system}")
    inductor_config.cpp.cxx = (None, system)
    return system


def aot_compile(fn: Callable, *example_args: Any):
    """Ahead-of-time compile ``fn`` (a module or a callable) for
    ``example_args``: `torch.export.export` under inference mode, then
    `aoti_compile_and_package` and `aoti_load_package`; returns the loaded
    callable (the explicit analogue of `builder->buildCudaEngine`)."""
    ep = _export(fn, example_args)
    cpp_compiler()
    with tempfile.TemporaryDirectory() as td:
        pkg = torch._inductor.aoti_compile_and_package(
            ep, package_path=os.path.join(td, "engine.pt2"),
            inductor_configs=INDUCTOR_CONFIGS)
        return torch._inductor.aoti_load_package(pkg)


def save_engine(path, module: torch.nn.Module, *example_args: Any,
                extras: Optional[dict] = None) -> dict:
    """Export ``module`` for ``example_args``, compile it into an
    AOTInductor package at ``path`` with its weights inside as constants,
    and write the sidecar ``<path>.json`` (see the module docstring).
    ``extras``: a JSON-serializable dict returned by `load_engine`.
    Returns the sidecar's contents.

    Production builds go through `runtime.engine_builder`, which compiles
    in a pristine subprocess, as the JAX package does."""
    from redtail_tpu_torch.ops.convolution import record_switches

    device = _device_of(example_args)
    t0 = time.perf_counter()
    with record_switches() as log:
        ep = _export(module, example_args)
    t1 = time.perf_counter()
    switches = None
    if device.type == "cuda":
        allow = bool(log) and all(log)
        switches = {"cudnn.allow_tf32": allow, "matmul.allow_tf32": allow,
                    "cudnn.deterministic": True}
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    compiler = cpp_compiler()
    torch._inductor.aoti_compile_and_package(
        ep, package_path=str(path), inductor_configs=INDUCTOR_CONFIGS)
    meta = {"version": 1, "device": device.type,
            "export_s": t1 - t0, "compile_s": time.perf_counter() - t1,
            "compiler": compiler,
            "card": (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else None),
            "torch": torch.__version__, "switches": switches,
            "ops": sorted({str(n.target) for n in ep.graph.nodes
                           if str(n.target).startswith("redtail_torch.")}),
            "extras": extras}
    Path(str(path) + SIDECAR).write_text(json.dumps(meta, indent=1))
    return meta


def read_sidecar(path) -> dict:
    return json.loads(Path(str(path) + SIDECAR).read_text())


@contextlib.contextmanager
def _switches(switches: Optional[dict]):
    """The stored conv switches set around an engine call and restored
    after, under the lock every conv of the port takes."""
    if switches is None:
        yield
        return
    from redtail_tpu_torch.ops.convolution import _FLAGS_LOCK

    with _FLAGS_LOCK:
        saved = (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.deterministic)
        torch.backends.cudnn.allow_tf32 = switches["cudnn.allow_tf32"]
        torch.backends.cuda.matmul.allow_tf32 = switches["matmul.allow_tf32"]
        torch.backends.cudnn.deterministic = switches["cudnn.deterministic"]
        try:
            yield
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic) = saved


def load_engine(path, device=None):
    """Load a `save_engine` package for ``device`` (None: the card, see
    `resolve_device`): no tracing, no compilation, no model code. Returns
    ``(call, extras)``; ``call(*inputs)`` runs the engine under inference
    mode with the stored conv switches set.

    Raises where the engine was built for another device type or another
    card (the reference's plan files are device-specific too)."""
    meta = read_sidecar(path)
    device = resolve_device(device)
    if device.type != meta["device"]:
        raise ValueError(f"engine {path} was built for {meta['device']!r}, "
                         f"this process runs on {device.type!r} (engines "
                         "are device-specific, like the reference's plan "
                         "files)")
    index = -1
    if device.type == "cuda":
        name = torch.cuda.get_device_name(device)
        if name != meta["card"]:
            raise ValueError(f"engine {path} was built on {meta['card']!r}, "
                             f"this card is {name!r}")
        index = torch.cuda.current_device() if device.index is None \
            else device.index
    # the ops the engine calls must be registered in this process
    from redtail_tpu_torch.kernels import _ops  # noqa: F401

    runner = torch._inductor.aoti_load_package(str(path), device_index=index)
    switches = meta["switches"]

    def call(*inputs):
        with _switches(switches), torch.inference_mode():
            return runner(*inputs)

    return call, meta["extras"]
