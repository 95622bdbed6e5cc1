"""Hand-written Hopper kernels, each in a module beside its plain PyTorch
version, its wrapper and the wrapper's launch counter.

| module | replaces (TPU) | source |
| --- | --- | --- |
| `corr_cost_volume` | `redtail_tpu/kernels/cost_volume_pallas.py:43` `_corr_kernel` | `csrc/corr_cost_volume.cu` |

Kernels are compiled from `csrc/` at first use (`_build.build`), never at
import, so the CPU tests import every module without `nvcc`.
"""

from redtail_tpu_torch.kernels._build import KERNELS, build

__all__ = ["KERNELS", "build"]
