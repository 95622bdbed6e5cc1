"""Mean host ms a frame of the serving node's dispatch stage (the pinned
upload and the enqueue of the forward), from its `StageProfiler`, reset
after warm-up. Reads `node.dispatch_ms`, where it bounds the rate, and
`node.dispatch_ms.cam`, where it lies on every frame's latency."""


def read(run):
    return run.stages.get(f"stereo/{run.cell.config['model']}/dispatch")
