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

__all__ = ["Msg", "load_caffemodel", "load_prototxt", "parse_caffemodel",
           "parse_prototxt", "read_bin", "write_bin", "write_caffemodel"]
