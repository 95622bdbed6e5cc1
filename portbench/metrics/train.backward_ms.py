"""Device ms a step of the kernels, copies and memsets launched inside the
train step's span `train/backward` (the gradients zeroed and the
backward, the remat recompute in it; `parallel/training.py`), on any
host thread."""

REGIONS = ("train/backward",)


def read(run):
    if run.trace is None or not run.work:
        return None
    calls, seconds = run.trace.regions.get(REGIONS[0], (0, 0.0))
    if not calls:
        return None
    return 1e3 * seconds / run.work
