"""Training across the stereo stack (`redtail_tpu/parallel/`): the train
step. The JAX package's device-mesh sharding (`parallel/sharding.py`) is
ROADMAP module item 10, not ported yet."""

from redtail_tpu_torch.parallel.training import (
    OptimizerSpec,
    TrainState,
    make_train_step,
    smooth_l1_disparity_loss,
)

__all__ = ["OptimizerSpec", "TrainState", "make_train_step",
           "smooth_l1_disparity_loss"]
