"""Mean host ms a frame of the serving node's enqueue stage, inside its
dispatch (the input's normalization, the forward's enqueue and the wire
conversion), from the node's `StageProfiler`, reset after warm-up."""


def read(run):
    return run.stages.get(f"stereo/{run.cell.config['model']}/enqueue")
