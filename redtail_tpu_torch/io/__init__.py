"""File formats the port reads and writes."""

from redtail_tpu_torch.io.golden import read_bin, write_bin

__all__ = ["read_bin", "write_bin"]
