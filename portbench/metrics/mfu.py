"""Percent of the card's bf16 dense peak: the network's nominal operations
a forward at the run's size and batch (`harness/counts.py`: every conv and
transposed conv, conv3D_1 as the dense conv over the concat volume), times
the forwards' worth a unit of work counts (a served frame one; a train
step three, the forward and the input and weight gradients, the remat
recompute not counted), times the units completed, over the traced
window. Reads `mfu.serve` and `mfu.train`."""

from portbench.harness import counts


def read(run):
    if not run.work:
        return None
    flops = run.passes * counts.forward_flops(run.cell.config, run.hw,
                                              run.batch)
    return 100.0 * flops * run.work / run.window_s / counts.BF16_PEAK_FLOPS
