"""Multi-device execution of the stereo stack (`redtail_tpu/parallel/`):
meshes and sharded forwards (`sharding.py`), the train step with or
without a mesh (`training.py`); the port's own pieces are the ranks'
launcher (`launch.py`) and the halo exchange with the sharding context the
ops read (`ops/halo.py`, re-exported here)."""

from redtail_tpu_torch.ops.halo import (
    DISPARITY_AXIS,
    IMAGE_AXIS,
    exchange,
    gather,
    owned,
    sharded_axis,
)

from redtail_tpu_torch.parallel.sharding import (
    DATA_AXIS,
    SPATIAL_AXIS,
    batch_sharding,
    local_shard,
    make_mesh,
    replicate,
    shard_stereo_forward,
)
from redtail_tpu_torch.parallel.training import (
    OptimizerSpec,
    TrainState,
    make_train_step,
    smooth_l1_disparity_loss,
)

__all__ = [
    "make_mesh",
    "batch_sharding",
    "replicate",
    "shard_stereo_forward",
    "TrainState",
    "make_train_step",
    "smooth_l1_disparity_loss",
    "DATA_AXIS",
    "SPATIAL_AXIS",
    "local_shard",
    "OptimizerSpec",
    "exchange",
    "gather",
    "owned",
    "sharded_axis",
    "IMAGE_AXIS",
    "DISPARITY_AXIS",
]
