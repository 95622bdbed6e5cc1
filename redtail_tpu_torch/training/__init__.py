"""Training subsystems (`redtail_tpu/training/`): TrailNet's augmentation,
loss and train step (`training/trailnet.py`) and the stereo models'
training loop (`training/stereo.py`, over `parallel/training.py`)."""

from redtail_tpu_torch.training.trailnet import (
    augment_batch,
    make_trailnet_train_step,
    trail_loss,
)

__all__ = ["trail_loss", "augment_batch", "make_trailnet_train_step"]
