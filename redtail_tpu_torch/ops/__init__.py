"""Operators of the ResNet18-2D path, NHWC at the public functions."""

from redtail_tpu_torch.ops.activations import elu, sigmoid
from redtail_tpu_torch.ops.convolution import (
    conv2d,
    conv2d_transpose,
    tf_same_padding,
)
from redtail_tpu_torch.ops.cost_volume import corr_cost_volume_dlast
from redtail_tpu_torch.ops.softargmax import softargmax, softargmin

__all__ = ["conv2d", "conv2d_transpose", "corr_cost_volume_dlast", "elu",
           "sigmoid", "softargmax", "softargmin", "tf_same_padding"]
