"""npz parameter bundles (`redtail_tpu/utils/checkpoint.py`).

The JAX package stores bf16 leaves as uint16 bit patterns under a
``@bf16``-suffixed key (npz cannot hold bfloat16). The port writes and
reads the same files without `ml_dtypes`:

- `load_npz_flat` widens ``@bf16`` leaves to float32 (exact): what the
  models load, casting to their dtype;
- `save_params` / `load_params` round-trip a nested param dict in both
  packages' format. numpy has no bfloat16, so a bf16 leaf is a CPU
  ``torch.bfloat16`` tensor here: `save_params` writes it as its uint16
  bits under ``@bf16``, `load_params` gives it back as one. Every other
  leaf is a numpy array (a torch tensor is saved as its numpy value).

Only the portable ``.npz`` form is ported: the JAX package's orbax
directory checkpoints need orbax.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch

BF16_SUFFIX = "@bf16"


def load_npz_flat(path) -> Dict[str, np.ndarray]:
    """Flat {key: array} of an npz file, ``@bf16`` leaves widened to
    float32 (exact) under their key without the suffix."""
    with np.load(path) as npz:
        flat = _decode_npz({k: npz[k] for k in npz.files})
    return {k: v.float().numpy() if isinstance(v, torch.Tensor) else v
            for k, v in flat.items()}


def _flatten(tree, prefix: str = "", out=None) -> Dict[str, Any]:
    """Nested dict -> {"a/b/c": leaf}, in the tree's order."""
    out = {} if out is None else out
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}/", out)
    else:
        out[prefix.rstrip("/")] = tree
    return out


def _unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, val in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def _encode_npz(flat: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Leaves as npz arrays: a ``torch.bfloat16`` leaf as its uint16 bit
    pattern under a ``@bf16``-suffixed key (lossless), any other tensor as
    its numpy value."""
    out = {}
    for k, v in flat.items():
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu()
            if v.dtype == torch.bfloat16:
                out[k + BF16_SUFFIX] = v.contiguous().view(
                    torch.int16).numpy().view(np.uint16)
                continue
            v = v.numpy()
        out[k] = np.asarray(v)
    return out


def _decode_npz(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """The inverse of `_encode_npz`: ``@bf16`` leaves as CPU
    ``torch.bfloat16`` tensors of the same bits, the rest as they are."""
    out = {}
    for k, v in flat.items():
        if k.endswith(BF16_SUFFIX):
            out[k[:-len(BF16_SUFFIX)]] = torch.from_numpy(
                np.ascontiguousarray(v, np.uint16).view(np.int16)).view(
                torch.bfloat16)
        else:
            out[k] = v
    return out


def save_params(params, path) -> Path:
    """Save a nested param dict (numpy arrays or torch tensors) as a
    portable ``.npz`` that the JAX package's `load_params` reads."""
    path = Path(path)
    if path.suffix != ".npz":
        raise ValueError(f"{path}: the port writes .npz bundles only (the "
                         "JAX package's orbax directories need orbax)")
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **_encode_npz(_flatten(params)))
    return path


def load_params(path) -> Dict[str, Any]:
    """A ``.npz`` bundle of either package as a nested dict (see the module
    docstring for bf16 leaves)."""
    path = Path(path)
    if path.suffix != ".npz":
        raise ValueError(f"{path}: the port reads .npz bundles only (the "
                         "JAX package's orbax directories need orbax)")
    with np.load(path) as data:
        return _unflatten(_decode_npz({k: data[k] for k in data.files}))
