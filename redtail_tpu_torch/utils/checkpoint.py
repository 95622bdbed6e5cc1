"""npz parameter bundles (`redtail_tpu/utils/checkpoint.py`).

The JAX package stores bf16 leaves as uint16 bit patterns under a
``@bf16``-suffixed key (npz cannot hold bfloat16). Decoding widens them to
float32, which is exact, so no `ml_dtypes` is needed; the model casts to
its dtype at load.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

BF16_SUFFIX = "@bf16"


def load_npz_flat(path) -> Dict[str, np.ndarray]:
    """Flat {key: array} of an npz file, ``@bf16`` leaves decoded to
    float32 under their key without the suffix."""
    out = {}
    with np.load(path) as npz:
        for key in npz.files:
            arr = npz[key]
            if key.endswith(BF16_SUFFIX):
                key = key[:-len(BF16_SUFFIX)]
                arr = (arr.astype(np.uint32) << 16).view(np.float32)
            out[key] = arr
    return out
