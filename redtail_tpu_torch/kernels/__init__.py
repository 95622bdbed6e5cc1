"""Hand-written Hopper kernels, each in a module beside its plain PyTorch
version, its wrapper and the wrapper's launch counter.

| module | replaces (TPU) | source |
| --- | --- | --- |
| `corr_cost_volume` | `redtail_tpu/kernels/cost_volume_pallas.py:43` `_corr_kernel` | `csrc/corr_cost_volume.cu` |
| `cost_volume_concat` | `redtail_tpu/kernels/cost_volume_pallas.py:158` `_concat_kernel` | `csrc/cost_volume_concat.cu` |
| `fused_cv_emit` | `redtail_tpu/kernels/fused_cv_emit_pallas.py:65` `_emit_kernel` (unpacked layout) | `csrc/fused_cv_emit.cu` |

Kernels are compiled from `csrc/` at first use (`_build.build`), never at
import, so the CPU tests import every module without `nvcc`.
"""

from redtail_tpu_torch.kernels._build import KERNELS, build

__all__ = ["KERNELS", "build"]
