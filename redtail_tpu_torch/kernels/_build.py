"""Build the package's CUDA kernels from `csrc/` at first use, and the
wrappers' shared guard against autograd.

Each `csrc/<name>.cu` exposes a plain C interface and compiles with `nvcc`
for `sm_90a` into its own shared library under `redtail_tpu_torch/build/`
(listed in `.gitignore`), which the kernel's wrapper loads with `ctypes`.
The library's file name carries a hash of its source, so an edited source
is rebuilt and a stale library is never loaded. `build()` starts one `nvcc`
per missing library, all at once, and waits for them together.

The forward kernels are also `torch.library` custom ops (`_ops.py`), so
`torch.export` can trace a model through them. The correlation and concat
volumes have backward kernels of their own (`csrc/*_bwd.cu`), bound into
`torch.autograd.Function`s by their wrappers. The emission and conv223
kernels have none yet: `refuse_autograd` makes their wrappers raise, before
they launch, where autograd would otherwise lose the gradients of
everything upstream.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD = PACKAGE / "build"
KERNELS = ("corr_cost_volume", "cost_volume_concat", "fused_cv_emit",
           "conv223", "corr_cost_volume_bwd", "cost_volume_concat_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of redtail_tpu_torch are built "
        "from redtail_tpu_torch/csrc at first use and need the CUDA "
        "toolkit (put nvcc on PATH or set CUDA_HOME)")


def library_path(name: str) -> Path:
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes()).hexdigest()
    return BUILD / f"lib{name}-{digest[:12]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, Path]:
    """Compile every named kernel whose library is missing; returns the
    library path of each. Raises with nvcc's output if a build fails."""
    paths = {name: library_path(name) for name in names}
    jobs = {}
    for name, path in paths.items():
        if path.exists():
            continue
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, path)
    failed = []
    for name, (proc, tmp, path) in jobs.items():
        log, _ = proc.communicate()
        (BUILD / f"{name}.log").write_text(log)
        if proc.returncode:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
        else:
            os.replace(tmp, path)  # atomic: safe against a concurrent build
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if needed (once per
    process)."""
    return ctypes.CDLL(str(build((name,))[name]))


def needs_grad(*tensors: Optional[torch.Tensor]) -> bool:
    """Whether grad mode is on and an input requires grad."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def refuse_autograd(name: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise where grad mode is on and an input requires grad: the kernel
    writes its output through a raw pointer, so the output would have no
    ``grad_fn`` and a loss through it would silently drop the gradients of
    every layer upstream. Under `torch.no_grad()` / `torch.inference_mode()`
    (serving) nothing changes."""
    if needs_grad(*tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward yet (ROADMAP.md, kernel "
            "queue item 2), and an input requires grad; run it under "
            "torch.no_grad() or torch.inference_mode(), or on the CPU, whose "
            "plain version is differentiable")
