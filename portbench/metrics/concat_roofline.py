"""Percent of its roofline: the concat volume's byte bound (`harness/
counts.py`: two feature maps read, the (N, D, H', W', 2C) volume written,
at 3.35 TB/s) times its launches, over their device time. The train step
calls the kernel through its autograd function, outside the op
`redtail_torch::cost_volume_concat`, so the trace has no op region to
read: its kernels are matched by the name in `csrc/cost_volume_concat.cu`
(a stopgap). With remat a step runs it twice (forward and recompute)."""

from portbench.harness import counts

KERNEL = "concat_kernel"


def read(run):
    if run.trace is None:
        return None
    launches, seconds = run.trace.kernel_seconds(KERNEL)
    if not launches or seconds <= 0:
        return None
    bound = counts.concat_bytes(run.cell.config, run.hw, run.batch) \
        / counts.HBM_BYTES_PER_S
    return counts.roofline_share(bound, launches, seconds)
