"""YOLOv1 post-processing (`redtail_tpu/models/yolo.py`): grid decode + IOU
suppression, in numpy on the host.

Behavioral copy of the reference's host-side decoder
(`ros/packages/caffe_ros/include/caffe_ros/yolo_prediction.h`): 7x7 grid,
20 classes, 2 boxes/cell; per cell, the max-probability class is paired
with the max-confidence box (one candidate per cell); w/h are squared
(YOLO training convention, `yolo_prediction.h:62-64`); box coords clamp to
the image and truncate to int.

``filter_by_iou`` reproduces the reference's suppression exactly,
including its quirks: candidates are scanned in grid order (not sorted by
probability), suppression ignores class labels, and the intersection term
is `min(x1+w1-x2, x2+w2-x1)` — which over-counts when one box contains the
other (`yolo_prediction.h:107-108`). Parity beats elegance here: the
px4_controller's person-stop rule consumes these boxes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

GRID = 7
NUM_CLASSES = 20
NUM_BOXES = 2
NUM_COORDS = 4

# Pascal VOC labels; class 14 = person (the controller's stop class,
# `px4_controller/include/px4_controller/px4_controller.h:115-118`).
VOC_LABELS = [
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
]
PERSON_CLASS = 14


@dataclass
class ObjectPrediction:
    label: int
    prob: float
    x: int
    y: int
    w: int
    h: int

    def as_row(self):
        """caffe_ros output contract: (label, prob, x, y, w, h) float row
        (`caffe_ros.cpp:155-189` publishes an n x 6 32FC matrix)."""
        return [float(self.label), self.prob, float(self.x), float(self.y),
                float(self.w), float(self.h)]


def decode(predictions, img_w: int, img_h: int,
           prob_threshold: float = 0.1) -> List[ObjectPrediction]:
    """Decode a flat (1470,) YOLOv1 head output into box predictions."""
    p = np.asarray(predictions, np.float32).reshape(-1)
    n_cells = GRID * GRID
    assert p.size == n_cells * (NUM_BOXES * (NUM_COORDS + 1) + NUM_CLASSES), \
        p.size
    class_probs = p[: n_cells * NUM_CLASSES].reshape(n_cells, NUM_CLASSES)
    confs = p[n_cells * NUM_CLASSES:
              n_cells * (NUM_CLASSES + NUM_BOXES)].reshape(n_cells, NUM_BOXES)
    coords = p[n_cells * (NUM_CLASSES + NUM_BOXES):].reshape(
        n_cells, NUM_BOXES, NUM_COORDS)

    out: List[ObjectPrediction] = []
    for row in range(GRID):
        for col in range(GRID):
            icell = row * GRID + col
            label = int(np.argmax(class_probs[icell]))
            max_p = float(class_probs[icell, label])
            ibox = int(np.argmax(confs[icell]))
            score = float(confs[icell, ibox])
            if score * max_p < prob_threshold:
                continue
            bx, by, bw, bh = coords[icell, ibox]
            x = (bx + col) / GRID * img_w
            y = (by + row) / GRID * img_h
            w = max(float(bw), 0.0)
            h = max(float(bh), 0.0)
            w = w * w * img_w
            h = h * h * img_h
            x -= w / 2
            y -= h / 2
            x = min(max(x, 0.0), img_w - 1.0)
            y = min(max(y, 0.0), img_h - 1.0)
            w = min(w, img_w - x)
            h = min(h, img_h - y)
            if int(w) <= 0 or int(h) <= 0:
                # zero-area after truncation: the reference's asserts
                # (`yolo_prediction.h:80-83`) reject these outright
                continue
            out.append(ObjectPrediction(label, score * max_p,
                                        int(x), int(y), int(w), int(h)))
    return out


def filter_by_iou(preds: List[ObjectPrediction],
                  iou_threshold: float = 0.5) -> List[ObjectPrediction]:
    """Greedy duplicate suppression in scan order (reference semantics)."""
    src = list(preds)
    i1 = 0
    while i1 < len(src):
        b1 = src[i1]
        i2 = i1 + 1
        while i2 < len(src):
            b2 = src[i2]
            union = b1.w * b1.h + b2.w * b2.h
            wi = max(min(b1.x + b1.w - b2.x, b2.x + b2.w - b1.x), 0)
            hi = max(min(b1.y + b1.h - b2.y, b2.y + b2.h - b1.y), 0)
            inter = wi * hi
            denom = union - inter
            # decode never emits zero-area boxes, but guard anyway
            iou = inter / denom if denom > 0 else 1.0
            if iou > iou_threshold:
                del src[i2]
            else:
                i2 += 1
        i1 += 1
    return src


def postprocess(predictions, img_w: int, img_h: int, *,
                prob_threshold: float = 0.15,
                iou_threshold: float = 0.2) -> np.ndarray:
    """Full caffe_ros YOLO path -> (n, 6) float matrix
    [label, prob, x, y, w, h]. Thresholds default to the node's
    (`caffe_ros.cpp:54-55`: obj_det_threshold 0.15, iou_threshold 0.2)."""
    preds = filter_by_iou(decode(predictions, img_w, img_h, prob_threshold),
                          iou_threshold)
    if not preds:
        return np.zeros((0, 6), np.float32)
    return np.asarray([p.as_row() for p in preds], np.float32)
