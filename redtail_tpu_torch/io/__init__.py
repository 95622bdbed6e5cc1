"""File formats the port reads and writes."""

from redtail_tpu_torch.io.caffe import (
    Msg,
    load_caffemodel,
    load_prototxt,
    parse_caffemodel,
    parse_prototxt,
    write_caffemodel,
)
from redtail_tpu_torch.io.golden import read_bin, write_bin
from redtail_tpu_torch.io.tf_checkpoint import load_checkpoint, read_index
from redtail_tpu_torch.io.trt_weights import (
    read_trt_weights,
    sniff_dtype,
    write_trt_weights,
)

__all__ = ["Msg", "load_caffemodel", "load_checkpoint", "load_prototxt",
           "parse_caffemodel", "parse_prototxt", "read_bin", "read_index",
           "read_trt_weights", "sniff_dtype", "write_bin",
           "write_caffemodel", "write_trt_weights"]
