"""Model zoo: the four stereo networks."""

from redtail_tpu_torch.models.stereo import (
    STEREO_SPECS,
    StereoNet,
    StereoSpec,
    init_stereo_params,
    params_from_npz,
    params_from_numpy,
    params_to_numpy,
    stereo_forward,
    use_packed3d,
)

__all__ = ["STEREO_SPECS", "StereoNet", "StereoSpec", "init_stereo_params",
           "params_from_npz", "params_from_numpy", "params_to_numpy",
           "stereo_forward", "use_packed3d"]
