"""Model zoo: the stereo networks (ResNet18-2D ported)."""

from redtail_tpu_torch.models.stereo import (
    STEREO_SPECS,
    StereoNet,
    StereoSpec,
    init_stereo_params,
    params_from_npz,
    params_from_numpy,
    params_to_numpy,
    stereo_forward,
)

__all__ = ["STEREO_SPECS", "StereoNet", "StereoSpec", "init_stereo_params",
           "params_from_npz", "params_from_numpy", "params_to_numpy",
           "stereo_forward"]
