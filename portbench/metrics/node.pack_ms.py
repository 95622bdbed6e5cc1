"""Mean host ms a frame of the serving node's pack stage (its resize check,
BGR -> RGB and space-to-depth pack), from the node's `StageProfiler`,
reset after warm-up."""


def read(run):
    return run.stages.get(f"stereo/{run.cell.config['model']}/pack")
