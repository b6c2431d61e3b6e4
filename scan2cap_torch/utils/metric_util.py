"""Class-agnostic box precision/recall (a copy of
``scan2cap_tpu/utils/metric_util.py``; the reference's VoteNet helper,
utils/metric_util.py:24-131, duplicated in benchmark/metric_util.py).

Boxes are (cx, cy, cz, dx, dy, dz); predictions carry a 7th confidence
column.  A prediction is a TP when it overlaps ANY ground-truth box at
IoU >= iou_thresh (no one-to-one matching, classes ignored) — same counting
as the reference.  Vectorized over the box pairs instead of its per-pair
Python loops.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def calc_iou(box_a: np.ndarray, box_b: np.ndarray) -> float:
    """Axis-aligned IoU of two (6,) center+size boxes
    (utils/metric_util.py:98-121)."""
    return float(_iou_matrix(np.asarray(box_a)[None],
                             np.asarray(box_b)[None])[0, 0])


def _iou_matrix(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """(N, 6) x (M, 6) -> (N, M) AABB IoU; pairs that do not strictly
    overlap on every axis score exactly 0 (the reference's early return)."""
    a_lo = boxes_a[:, :3] - boxes_a[:, 3:6] / 2
    a_hi = boxes_a[:, :3] + boxes_a[:, 3:6] / 2
    b_lo = boxes_b[:, :3] - boxes_b[:, 3:6] / 2
    b_hi = boxes_b[:, :3] + boxes_b[:, 3:6] / 2
    lo = np.maximum(a_lo[:, None], b_lo[None])
    hi = np.minimum(a_hi[:, None], b_hi[None])
    overlap = (hi > lo).all(-1)
    inter = np.where(overlap, (hi - lo).prod(-1), 0.0)
    vol_a = boxes_a[:, 3:6].prod(-1)
    vol_b = boxes_b[:, 3:6].prod(-1)
    union = vol_a[:, None] + vol_b[None] - inter
    return np.where(overlap, inter / union, 0.0)


def single_scene_precision_recall(labels: np.ndarray, pred: np.ndarray,
                                  iou_thresh: float, conf_thresh: float
                                  ) -> Tuple[int, int, int]:
    """TP/FP/FN for one scene (utils/metric_util.py:54-89): predictions
    filtered by confidence (col 6), matched class-agnostically."""
    gt = np.asarray(labels)[:, :6]
    pred = np.asarray(pred)
    keep = pred[:, 6] > conf_thresh
    boxes = pred[keep, :6]
    if len(boxes) == 0 or len(gt) == 0:
        return 0, len(boxes), len(gt)
    good = _iou_matrix(boxes, gt) >= iou_thresh
    tp = int(good.any(1).sum())
    fp = len(boxes) - tp
    fn = len(gt) - int(good.any(0).sum())
    return tp, fp, fn


def precision_recall(tp: int, fp: int, fn: int) -> Tuple[float, float]:
    prec = tp / (tp + fp) if tp + fp > 0 else 0.0
    rec = tp / (tp + fn)
    return prec, rec


def multi_scene_precision_recall(
    labels: np.ndarray,            # (B, N, 6)
    pred: np.ndarray,              # (B, M, 7)
    iou_thresh: float,
    conf_thresh: float,
    label_mask: Optional[np.ndarray] = None,   # (B, N) 0/1
    pred_mask: Optional[np.ndarray] = None,    # (B, M) 0/1
):
    """Batch accumulation (utils/metric_util.py:24-51).
    Returns (TP, FP, FN, (precision, recall))."""
    labels = np.asarray(labels)
    pred = np.asarray(pred)
    if label_mask is None:
        label_mask = np.ones(labels.shape[:2])
    if pred_mask is None:
        pred_mask = np.ones(pred.shape[:2])
    tp = fp = fn = 0
    for b in range(labels.shape[0]):
        t, f, n = single_scene_precision_recall(
            labels[b][label_mask[b] == 1], pred[b][pred_mask[b] == 1],
            iou_thresh, conf_thresh)
        tp, fp, fn = tp + t, fp + f, fn + n
    return tp, fp, fn, precision_recall(tp, fp, fn)
