"""Device kernels, copies and memsets in the traced window, per unit of
work completed in it: a frame (`launches.serve`) or a train step
(`launches.train`)."""


def read(run):
    if run.trace is None or not run.work:
        return None
    return run.trace.device_ops / run.work
