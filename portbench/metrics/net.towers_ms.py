"""Device ms a frame of the kernels, copies and memsets launched inside
the stereo net's span `stereo/towers` (the 2D towers, in any form;
`models/stereo.py:layer_stage`), on any host thread."""

REGIONS = ("stereo/towers",)


def read(run):
    if run.trace is None or not run.work:
        return None
    calls, seconds = run.trace.regions.get(REGIONS[0], (0, 0.0))
    if not calls:
        return None
    return 1e3 * seconds / run.work
