"""Trail-following dataset tooling (`redtail_tpu/data/trails.py`).

Reference: `models/dataset/idsia_trails_dataset_digits.py` — the IDSIA
forest-trail dataset has per-video directories each containing three
camera-orientation class folders (`lc`: left camera -> "trail is to the
right", `sc`: straight, `rc`: right camera); the list script emits
(path, label) lists with **per-directory class balancing** (oversample
each class folder to the largest folder's count, `:42-57`) and fixed
train/val/test video splits (`:9-15`).

This module reproduces that workflow framework-side: list building,
balancing, and a batching loader that feeds the TrailNet train step.
"""

from __future__ import annotations

import random
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# label_map.txt: index order of the class folders
CLASS_FOLDERS = ("lc", "sc", "rc")
LABELS = {name: i for i, name in enumerate(CLASS_FOLDERS)}

# The reference pinned which recorded videos belong to which split.
DEFAULT_SPLITS = {
    "val": ("001", "007"),
    "test": ("008", "010"),
}

IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".bmp"}


def balance_samples(per_class: Dict[int, List], seed: int = 0
                    ) -> List[Tuple]:
    """Oversample every class to the max class count (reference
    `sample_balance_dir`): duplicates are drawn uniformly at random."""
    rng = random.Random(seed)
    if not per_class:
        return []
    target = max(len(v) for v in per_class.values())
    out: List[Tuple] = []
    for label, items in sorted(per_class.items()):
        take = list(items)
        while len(take) < target and items:
            take.append(rng.choice(items))
        out.extend(take)
    rng.shuffle(out)
    return out


def build_trail_lists(root, *, splits: Optional[Dict] = None,
                      balance: bool = True, seed: int = 0
                      ) -> Dict[str, List[Tuple[str, int]]]:
    """Scan `<root>/<video>/<class>/*.jpg` into split -> [(path, label)].

    Videos listed in ``splits`` go to val/test; the rest train. Balancing
    applies per video directory, train split only (as the reference did).
    """
    root = Path(root)
    splits = DEFAULT_SPLITS if splits is None else splits
    video_split = {}
    for split, vids in splits.items():
        for v in vids:
            video_split[v] = split
    out: Dict[str, List[Tuple[str, int]]] = {"train": [], "val": [],
                                             "test": []}
    for video_dir in sorted(p for p in root.iterdir() if p.is_dir()):
        split = video_split.get(video_dir.name, "train")
        per_class: Dict[int, List[Tuple[str, int]]] = {}
        for cls in CLASS_FOLDERS:
            cdir = video_dir / cls
            if not cdir.is_dir():
                continue
            files = sorted(str(p) for p in cdir.iterdir()
                           if p.suffix.lower() in IMAGE_EXTS)
            per_class[LABELS[cls]] = [(f, LABELS[cls]) for f in files]
        if balance and split == "train":
            out[split].extend(balance_samples(per_class, seed))
        else:
            for items in per_class.values():
                out[split].extend(items)
    return out


class TrailsDataset:
    """Minimal batching loader over a (path, label) list."""

    def __init__(self, samples: Sequence[Tuple[str, int]],
                 image_hw: Tuple[int, int] = (180, 320), seed: int = 0):
        self.samples = list(samples)
        self.image_hw = image_hw
        self._rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.samples)

    def _load(self, path):
        import cv2

        img = cv2.imread(path)
        h, w = self.image_hw
        img = cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)
        return img.astype(np.float32)

    def batches(self, batch_size: int, *, shuffle: bool = True,
                drop_last: bool = True):
        order = np.arange(len(self.samples))
        if shuffle:
            self._rng.shuffle(order)
        for i in range(0, len(order), batch_size):
            idx = order[i:i + batch_size]
            if drop_last and len(idx) < batch_size:
                return
            imgs = np.stack([self._load(self.samples[j][0]) for j in idx])
            labels = np.array([self.samples[j][1] for j in idx], np.int32)
            yield imgs, labels
