"""redtail-tpu ported to PyTorch and CUDA on an NVIDIA H100.

The JAX package `redtail_tpu` is the reference that every module here is
checked against; this package imports none of it and none of JAX. Module
names follow the JAX package's so each counterpart is easy to find.

Entry points run on the card unless the caller asks for the CPU with
``device="cpu"`` (`resolve_device`).
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "seeded_generator"]


def resolve_device(device=None) -> torch.device:
    """``None`` means the card (``"cuda"``). A CUDA device without a card
    raises; the CPU is used only when asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: redtail_tpu_torch runs on the card "
            "unless the caller passes device='cpu'")
    return dev


def seeded_generator(seed: int, device=None) -> torch.Generator:
    """A `torch.Generator` on ``device`` (see `resolve_device`) seeded with
    ``seed``: the port's counterpart of a `jax.random` key. Its numbers
    differ from JAX's, so tests draw shared inputs from numpy instead."""
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(int(seed))
    return gen
