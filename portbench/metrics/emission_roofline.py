"""Percent of its roofline: the emission op's byte bound (`harness/
counts.py`: its maps and bias read once, its full-layout output written
once, at 3.35 TB/s) times its calls (the op's host regions in the traced
window), over the device time of the kernels launched inside those
regions."""

from portbench.harness import counts

REGIONS = ("redtail_torch::fused_cv_emit",)


def read(run):
    if run.trace is None or not run.work:
        return None
    calls, seconds = run.trace.regions.get(REGIONS[0], (0, 0.0))
    if not calls or seconds <= 0:
        return None
    bound = counts.emission_bytes(run.cell.config, run.hw, run.batch) \
        / counts.HBM_BYTES_PER_S
    return counts.roofline_share(bound, calls, seconds)
