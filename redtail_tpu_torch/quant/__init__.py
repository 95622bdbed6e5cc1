"""Post-training quantization (`redtail_tpu/quant`): entropy / percentile
calibration, per-channel int8 weights, the exact int8 conv, the stereo
w8 and int8 rungs and the Caffe graphs' int8 path."""

from redtail_tpu_torch.quant.ptq import (
    CalibrationCollector,
    amax_threshold,
    caffe_net_forward_int8,
    calibrate_caffe_net,
    calibrate_or_load,
    conv2d_int8,
    conv2d_w8,
    dequantize,
    dequantize_tree,
    entropy_threshold,
    load_calibration,
    quantize_act,
    quantize_per_channel,
    quantize_stereo_params_w8,
    save_calibration,
)
from redtail_tpu_torch.quant.stereo_int8 import (
    calibrate_stereo,
    int8_layer_paths,
    int8_prefixes,
    quantize_stereo_params_int8,
)

__all__ = [
    "entropy_threshold",
    "amax_threshold",
    "quantize_per_channel",
    "dequantize",
    "quantize_act",
    "conv2d_int8",
    "conv2d_w8",
    "quantize_stereo_params_w8",
    "dequantize_tree",
    "CalibrationCollector",
    "calibrate_caffe_net",
    "caffe_net_forward_int8",
    "calibrate_or_load",
    "save_calibration",
    "load_calibration",
    "calibrate_stereo",
    "int8_prefixes",
    "quantize_stereo_params_int8",
    "int8_layer_paths",
]
