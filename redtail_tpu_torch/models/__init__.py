"""Model zoo: the four stereo networks, the Caffe graph interpreter,
TrailNet and YOLO's post-processing. TrailNet's tree converters are
`models.trailnet.params_from_numpy` / `params_to_numpy` (the names here are
the stereo models')."""

from redtail_tpu_torch.models import yolo
from redtail_tpu_torch.models.caffe_net import CaffeNet
from redtail_tpu_torch.models.stereo import (
    STEREO_SPECS,
    StereoNet,
    StereoSpec,
    init_stereo_params,
    load_stereo_params,
    params_from_npz,
    params_from_numpy,
    params_from_trt_blob,
    params_to_trt_blob,
    params_to_numpy,
    stereo_forward,
    use_packed3d,
)
from redtail_tpu_torch.models.trailnet import (
    TrailNet,
    init_trailnet_params,
    load_trailnet,
    params_from_w8_npz,
    params_to_w8_npz,
    trailnet_forward,
    trailnet_predict,
)
from redtail_tpu_torch.models.trailnet_proto import (
    emit_trailnet_prototxt,
    native_params_to_blobs,
)

__all__ = ["CaffeNet", "STEREO_SPECS", "StereoNet", "StereoSpec", "TrailNet",
           "emit_trailnet_prototxt", "init_stereo_params",
           "init_trailnet_params", "load_stereo_params", "load_trailnet",
           "native_params_to_blobs", "params_from_npz", "params_from_numpy",
           "params_from_trt_blob", "params_from_w8_npz",
           "params_to_trt_blob",
           "params_to_numpy", "params_to_w8_npz", "stereo_forward",
           "trailnet_forward", "trailnet_predict", "use_packed3d", "yolo"]
