"""Quantization: the per-channel int8 weight helpers."""

from redtail_tpu_torch.quant.ptq import dequantize, quantize_per_channel

__all__ = ["dequantize", "quantize_per_channel"]
