"""Hand-written Hopper kernels, each in a module beside its plain PyTorch
version, its wrapper and the wrapper's launch counter.

| module | replaces (TPU) | source |
| --- | --- | --- |
| `corr_cost_volume` | `redtail_tpu/kernels/cost_volume_pallas.py:43` `_corr_kernel`; its VJP `_corr_bwd` (:113) | `csrc/corr_cost_volume.cu`; backward `csrc/corr_cost_volume_bwd.cu` |
| `cost_volume_concat` | `redtail_tpu/kernels/cost_volume_pallas.py:158` `_concat_kernel` (its gradient XLA's) | `csrc/cost_volume_concat.cu`; backward `csrc/cost_volume_concat_bwd.cu` |
| `fused_cv_emit` | `redtail_tpu/kernels/fused_cv_emit_pallas.py:65` `_emit_kernel` (unpacked and dh-shifted packed layouts) | `csrc/fused_cv_emit.cu` |
| `conv223` | `redtail_tpu/kernels/conv223_pallas.py:60` `_conv223_kernel` | `csrc/conv223.cu` |

Kernels are compiled from `csrc/` at first use (`_build.build`), never at
import, so the CPU tests import every module without `nvcc`. Importing the
package registers the four forward kernels as `torch.library` custom ops
(`_ops.py`), which the wrappers call.
"""

from redtail_tpu_torch.kernels import _ops  # noqa: F401  (registers the ops)
from redtail_tpu_torch.kernels._build import KERNELS, build

__all__ = ["KERNELS", "build"]
