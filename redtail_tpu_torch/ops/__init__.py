"""Operators of the stereo models, NHWC / NDHWC at the public functions."""

from redtail_tpu_torch.ops.activations import elu, sigmoid
from redtail_tpu_torch.ops.convolution import (
    conv2d,
    conv2d_transpose,
    conv3d,
    conv3d_transpose,
    plain_lowering,
    tf_same_padding,
)
from redtail_tpu_torch.ops.cost_volume import (
    corr_cost_volume_dlast,
    cost_volume,
)
from redtail_tpu_torch.ops.fused_cost_volume_conv import cost_volume_conv3d
from redtail_tpu_torch.ops.softargmax import softargmax, softargmin

__all__ = ["conv2d", "conv2d_transpose", "conv3d", "conv3d_transpose",
           "corr_cost_volume_dlast", "cost_volume", "cost_volume_conv3d",
           "elu", "plain_lowering", "sigmoid", "softargmax", "softargmin",
           "tf_same_padding"]
