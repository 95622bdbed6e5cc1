"""Mean host ms a frame of the serving node's upload stage, inside its
dispatch (the pinned ring's wait, the copy into the pinned buffer and
the H2D enqueue), from the node's `StageProfiler`, reset after warm-up."""


def read(run):
    return run.stages.get(f"stereo/{run.cell.config['model']}/upload")
