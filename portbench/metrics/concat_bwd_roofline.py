"""Percent of its roofline: the concat volume's backward byte bound
(`harness/counts.py`: the volume's cotangent read, the two feature
gradients written, at 3.35 TB/s) times its launches, over their device
time; kernels matched by the name in `csrc/cost_volume_concat_bwd.cu` (no
op region wraps the backward)."""

from portbench.harness import counts

KERNEL = "concat_bwd_kernel"


def read(run):
    if run.trace is None:
        return None
    launches, seconds = run.trace.kernel_seconds(KERNEL)
    if not launches or seconds <= 0:
        return None
    bound = counts.concat_bwd_bytes(run.cell.config, run.hw, run.batch) \
        / counts.HBM_BYTES_PER_S
    return counts.roofline_share(bound, launches, seconds)
