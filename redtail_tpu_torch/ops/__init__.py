"""Operators of the model zoo, NHWC / NDHWC at the public functions."""

from redtail_tpu_torch.ops.activations import elu, sigmoid, srelu
from redtail_tpu_torch.ops.convolution import (
    conv2d,
    conv2d_round_once,
    conv2d_transpose,
    conv2d_transpose_shuffle,
    conv3d,
    conv3d_transpose,
    conv3d_transpose_dfold,
    conv3d_transpose_shuffle,
    linear_fp32,
    packed3d_lowering,
    plain_lowering,
    tf_same_padding,
)
from redtail_tpu_torch.ops.cost_volume import (
    corr_cost_volume_dlast,
    corr_softargmax_dlast,
    cost_volume,
)
from redtail_tpu_torch.ops.fused_cost_volume_conv import cost_volume_conv3d
from redtail_tpu_torch.ops.preprocess import preprocess_caffe_host
from redtail_tpu_torch.ops.softargmax import softargmax, softargmin

__all__ = ["conv2d", "conv2d_round_once", "conv2d_transpose",
           "conv2d_transpose_shuffle", "conv3d", "conv3d_transpose",
           "conv3d_transpose_dfold", "conv3d_transpose_shuffle",
           "corr_cost_volume_dlast", "corr_softargmax_dlast", "cost_volume",
           "cost_volume_conv3d", "elu", "linear_fp32",
           "packed3d_lowering", "plain_lowering", "preprocess_caffe_host",
           "sigmoid", "softargmax", "softargmin", "srelu",
           "tf_same_padding"]
