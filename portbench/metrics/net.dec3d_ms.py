"""Device ms a frame of the kernels, copies and memsets launched inside
the stereo net's span `stereo/dec3d` (the 3D decoder;
`models/stereo.py:layer_stage`), on any host thread."""

REGIONS = ("stereo/dec3d",)


def read(run):
    if run.trace is None or not run.work:
        return None
    calls, seconds = run.trace.regions.get(REGIONS[0], (0, 0.0))
    if not calls:
        return None
    return 1e3 * seconds / run.work
