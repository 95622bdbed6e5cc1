"""Dataset tooling: trail-dataset list building/loading (the DIGITS-list
workflow of `models/dataset/idsia_trails_dataset_digits.py` rebuilt as
plain Python + numpy batching) and the KITTI-format stereo loader
feeding the native trainer (`training/stereo.py`)."""

from redtail_tpu_torch.data.kitti import KittiStereoDataset, make_synthetic_kitti
from redtail_tpu_torch.data.trails import (
    TrailsDataset,
    balance_samples,
    build_trail_lists,
)

__all__ = ["build_trail_lists", "balance_samples", "TrailsDataset",
           "KittiStereoDataset", "make_synthetic_kitti"]
