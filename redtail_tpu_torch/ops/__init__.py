"""Operators of the stereo models, NHWC / NDHWC at the public functions."""

from redtail_tpu_torch.ops.activations import elu, sigmoid
from redtail_tpu_torch.ops.convolution import (
    conv2d,
    conv2d_transpose,
    conv3d,
    conv3d_transpose,
    conv3d_transpose_dfold,
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
from redtail_tpu_torch.ops.softargmax import softargmax, softargmin

__all__ = ["conv2d", "conv2d_transpose", "conv3d", "conv3d_transpose",
           "conv3d_transpose_dfold", "corr_cost_volume_dlast",
           "corr_softargmax_dlast", "cost_volume", "cost_volume_conv3d",
           "elu", "packed3d_lowering", "plain_lowering", "sigmoid",
           "softargmax", "softargmin", "tf_same_padding"]
