"""KITTI-2015-format stereo dataset loader (`redtail_tpu/data/kitti.py`).

The reference reported its headline accuracy as KITTI 2015 D1 error
(`stereoDNN/README.md:28-31,35-36`: "KITTI 2015 dataset
(200 training images)") but shipped neither the evaluation tool nor a
training loader — training lived in external TF rigs. This module supplies
the data side of the framework's own train/eval loop
(`training/stereo.py`).

Two directory layouts are accepted:

- KITTI 2015:   ``<root>/image_2/*_10.png`` (left),
  ``<root>/image_3/*_10.png`` (right), ``<root>/disp_occ_0/*_10.png``
  (uint16 PNG, disparity*256, 0 = invalid). A ``training/`` subdirectory
  is descended into automatically.
- generic:      ``<root>/left/*.png``, ``<root>/right/*.png``,
  ``<root>/disp/*.{png,npy}`` (same uint16*256 convention for PNG; .npy
  holds float disparity in px directly, NaN/<=0 = invalid).

Images load as float32 RGB in [0, 1] — the convention of the whole
framework, matching the reference's ``readImgFile`` (/255,
``sample_app/main.cpp:83-98``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np


def _load_image(path: Path) -> np.ndarray:
    import cv2

    img = cv2.imread(str(path), cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return img[..., ::-1].astype(np.float32) / 255.0  # BGR -> RGB, [0,1]


def _load_disparity(path: Path) -> np.ndarray:
    """Disparity map in px, NaN where invalid."""
    if path.suffix == ".npy":
        disp = np.load(path).astype(np.float32)
        disp = np.where(disp > 0, disp, np.nan)
        return disp
    import cv2

    raw = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    if raw is None:
        raise FileNotFoundError(path)
    if raw.ndim == 3:
        raw = raw[..., 0]
    disp = raw.astype(np.float32) / 256.0  # KITTI devkit convention
    return np.where(raw > 0, disp, np.nan)


def _index_dir(d: Path, exts=(".npy", ".png", ".jpg")) -> dict:
    """stem -> path; on duplicate stems the earlier extension in ``exts``
    wins (.npy float GT over a same-named visualization .png)."""
    out: dict = {}
    for p in sorted(d.iterdir()):
        if p.suffix not in exts:
            continue
        prev = out.get(p.stem)
        if prev is None or exts.index(p.suffix) < exts.index(prev.suffix):
            out[p.stem] = p
    return out


class KittiStereoDataset:
    """Indexed loader over a KITTI-format stereo directory.

    ``sample(i)`` returns ``(left, right, disp, valid)``: float32 images
    (H, W, 3) in [0,1], disparity (H, W) in px with invalid pixels zeroed,
    and a {0,1} float validity mask.
    """

    def __init__(self, root, *, require_gt: bool = True):
        root = Path(root)
        if (root / "training").is_dir() and not (root / "image_2").is_dir():
            root = root / "training"
        self.root = root
        if (root / "image_2").is_dir():
            left_d, right_d = root / "image_2", root / "image_3"
            disp_d = root / "disp_occ_0"
        elif (root / "left").is_dir():
            left_d, right_d, disp_d = (root / "left", root / "right",
                                       root / "disp")
        else:
            raise FileNotFoundError(
                f"{root}: neither KITTI (image_2/image_3/disp_occ_0) nor "
                "generic (left/right/disp) layout found")
        left, right = _index_dir(left_d), _index_dir(right_d)
        disp = _index_dir(disp_d) if disp_d.is_dir() else {}
        keys = sorted(set(left) & set(right))
        if require_gt:
            keys = [k for k in keys if k in disp]
        if not keys:
            raise FileNotFoundError(f"{root}: no stereo pairs found")
        self._items = [(left[k], right[k], disp.get(k)) for k in keys]

    def __len__(self) -> int:
        return len(self._items)

    def sample(self, i: int):
        lp, rp, dp = self._items[i]
        left, right = _load_image(lp), _load_image(rp)
        if dp is None:
            disp = np.full(left.shape[:2], np.nan, np.float32)
        else:
            disp = _load_disparity(dp)
        if disp.shape != left.shape[:2]:
            raise ValueError(
                f"{dp}: disparity shape {disp.shape} != image "
                f"{left.shape[:2]}")
        valid = np.isfinite(disp).astype(np.float32)
        return left, right, np.nan_to_num(disp), valid

    # ---------------------------------------------------------- batching

    def _crop(self, arrs, hw: Tuple[int, int], rng: np.random.RandomState,
              random: bool, *, valid_last: bool = True):
        """Crop all arrays identically to (h, w); edge-pad if the frame is
        smaller — except the final array (the validity mask, when
        ``valid_last``), which zero-pads so fabricated pixels never
        supervise the loss."""
        h, w = hw
        ih, iw = arrs[0].shape[:2]
        if ih < h or iw < w:
            ph, pw = max(0, h - ih), max(0, w - iw)
            padded = []
            for j, a in enumerate(arrs):
                pad = ((0, ph), (0, pw)) + ((0, 0),) * (a.ndim - 2)
                mode = ("constant" if valid_last and j == len(arrs) - 1
                        else "edge")
                padded.append(np.pad(a, pad, mode=mode))
            arrs, (ih, iw) = padded, (max(ih, h), max(iw, w))
        if random:
            y = rng.randint(0, ih - h + 1)
            x = rng.randint(0, iw - w + 1)
        else:
            y, x = (ih - h) // 2, (iw - w) // 2
        return [a[y:y + h, x:x + w] for a in arrs]

    def batches(self, batch_size: int, crop_hw: Tuple[int, int], *,
                rng: Optional[np.random.RandomState] = None,
                shuffle: bool = True, drop_last: bool = True,
                random_crop: Optional[bool] = None,
                ) -> Iterator[Tuple[np.ndarray, ...]]:
        """Yield (left, right, disp, valid) batches of random crops.

        Edge-pads frames smaller than the crop (the crop must still be a
        valid model input size for the chosen spec). ``random_crop``
        controls crop sampling independently of batch-order ``shuffle``
        (default: follow ``shuffle``).
        """
        if drop_last and len(self) < batch_size:
            raise ValueError(
                f"dataset has {len(self)} samples < batch_size "
                f"{batch_size} (drop_last yields no batches)")
        if random_crop is None:
            random_crop = shuffle
        rng = rng or np.random.RandomState(0)
        order = np.arange(len(self))
        if shuffle:
            rng.shuffle(order)
        for i in range(0, len(order), batch_size):
            idx = order[i:i + batch_size]
            if drop_last and len(idx) < batch_size:
                return
            ls, rs, ds, vs = [], [], [], []
            for j in idx:
                left, right, disp, valid = self.sample(int(j))
                left, right, disp, valid = self._crop(
                    [left, right, disp, valid], crop_hw, rng,
                    random=random_crop)
                ls.append(left); rs.append(right)
                ds.append(disp); vs.append(valid)
            yield (np.stack(ls), np.stack(rs), np.stack(ds), np.stack(vs))


def make_synthetic_kitti(root, *, n: int = 4, hw: Tuple[int, int] = (48, 96),
                         disp=3.0, seed: int = 0, octaves: int = 1) -> Path:
    """Write a tiny generic-layout dataset where right = left shifted by a
    per-image constant disparity — a learnable toy task for tests and
    smoke runs. ``disp``: one value, or an (lo, hi) range sampled
    per image (forcing the net to correlate rather than learn a bias).
    ``octaves``: extra finer-scale texture layers — the single /4-scale
    cubic texture is locally near-uniform, which caps how precisely a
    correlation model can localize the shift (measured: ResNet-18 3D
    plateaued at ~2 px EPE on octaves=1, converged on octaves=3)."""
    import cv2

    root = Path(root)
    rng = np.random.RandomState(seed)
    for sub in ("left", "right", "disp"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    h, w = hw
    lo, hi = (disp, disp) if np.isscalar(disp) else disp
    for i in range(n):
        d = int(rng.randint(round(lo), round(hi) + 1))
        # Smooth random texture so the shift is recoverable by correlation.
        tex = np.zeros((h, w + d, 3), np.float32)
        weight_sum = 0.0
        for o in range(octaves):
            scale = 4 >> min(o, 2) if o < 3 else 1
            wgt = 1.0 / (1 + o)
            base = rng.rand(max(h // scale, 1),
                            max((w + d) // scale, 1) + 1,
                            3).astype(np.float32)
            tex += wgt * cv2.resize(base, (w + d, h),
                                    interpolation=cv2.INTER_CUBIC)
            weight_sum += wgt
        tex = np.clip(tex / weight_sum, 0, 1)
        # Stereo convention (matching the cost volume's right-shift,
        # ops/cost_volume.py): left[x] corresponds to right[x - d].
        left = tex[:, :w]
        right = tex[:, d:d + w]
        gt = np.full((h, w), float(d), np.float32)
        gt[:, :d] = np.nan  # no right correspondence at the left edge
        cv2.imwrite(str(root / "left" / f"{i:03d}.png"),
                    (left[..., ::-1] * 255).astype(np.uint8))
        cv2.imwrite(str(root / "right" / f"{i:03d}.png"),
                    (right[..., ::-1] * 255).astype(np.uint8))
        np.save(root / "disp" / f"{i:03d}.npy", gt)
    return root
