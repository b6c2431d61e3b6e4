"""Detection AP evaluation (counterpart of ``scan2cap_tpu/eval/ap_helper.py``;
reference lib/ap_helper.py, utils/eval_det.py, utils/nms.py).

* ``parse_predictions_device`` runs on the model's device: objectness and
  class probabilities, remove_empty_box and class-aware NMS;
* list assembly and the VOC AP accumulation stay on the host, as copies of
  the JAX package's host half (``np.argsort(-confidence)``'s unstable order
  included, so both packages rank detections alike).

Output structures match the reference:
  batch_pred_map_cls: per scene [(cls, corners (8,3), score)], with
  per_class_proposal expansion (score = sem_prob * obj_prob) and the
  conf_thresh filter (ap_helper.py:165-178);
  batch_gt_map_cls: per scene [(cls, corners)].
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from scan2cap_torch.config import SCANNET_CLASS2TYPE
from scan2cap_torch.ops.nms import nms_3d


def nonempty_boxes(corners: torch.Tensor, points: torch.Tensor,
                   min_points: int = 5) -> torch.Tensor:
    """remove_empty_box (ap_helper.py:89-106 via POST_DICT): (B, K) bool,
    true where at least ``min_points`` of the scene's points lie inside the
    box's axis-aligned extent, bounds included.  The reference tests the
    convex hull of the same axis-aligned corners: the same predicate.

    corners (B, K, 8, 3), points (B, N, >=3).  The (B, K, N) test is one
    bool tensor per axis, and the count is int32: no (B, K, N, 3) float
    tensor is made."""
    lo, hi = corners.amin(dim=2), corners.amax(dim=2)      # (B, K, 3)
    inside = None
    for a in range(3):
        p = points[:, None, :, a]                          # (B, 1, N)
        axis = (p >= lo[:, :, a, None]) & (p <= hi[:, :, a, None])
        inside = axis if inside is None else inside & axis
    return inside.sum(dim=-1, dtype=torch.int32) >= min_points


def parse_predictions_device(data_dict: Dict) -> Dict:
    """Everything NMS and AP need, on the model's device.

    Reads the model outputs (bbox_corner, objectness_scores,
    sem_cls_scores) and, when present, the input ``point_clouds`` (without
    them remove_empty_box keeps every box).  Returns {pred_mask, obj_prob,
    sem_cls_probs, pred_sem_cls}; the NMS syncs with the host once."""
    obj_prob = torch.softmax(data_dict["objectness_scores"], dim=-1)[..., 1]
    sem_probs = torch.softmax(data_dict["sem_cls_scores"], dim=-1)
    pred_sem_cls = torch.argmax(data_dict["sem_cls_scores"], dim=-1)
    corners = data_dict["bbox_corner"]
    if "point_clouds" in data_dict:
        nonempty = nonempty_boxes(corners, data_dict["point_clouds"])
    else:
        nonempty = torch.ones(obj_prob.shape, dtype=torch.bool,
                              device=obj_prob.device)
    pred_mask = nms_3d(corners, torch.where(nonempty, obj_prob, -1.0),
                       pred_sem_cls, iou_threshold=0.25, same_cls=True)
    return {
        "pred_mask": pred_mask & nonempty,
        "obj_prob": obj_prob,
        "sem_cls_probs": sem_probs,
        "pred_sem_cls": pred_sem_cls,
    }


def assemble_pred_map_cls(
    bbox_corner: np.ndarray,        # (B, K, 8, 3)
    parsed: Dict[str, np.ndarray],
    num_class: int = 18,
    conf_thresh: float = 0.05,
    per_class_proposal: bool = True,
) -> List[List[Tuple[int, np.ndarray, float]]]:
    """Host-side list assembly (ap_helper.py:165-178)."""
    B, K = parsed["obj_prob"].shape
    out = []
    for i in range(B):
        keep = (parsed["pred_mask"][i] == 1) & (parsed["obj_prob"][i] > conf_thresh)
        idx = np.where(keep)[0]
        cur = []
        if per_class_proposal:
            for c in range(num_class):
                cur += [(c, bbox_corner[i, j],
                         float(parsed["sem_cls_probs"][i, j, c]
                               * parsed["obj_prob"][i, j])) for j in idx]
        else:
            cur = [(int(parsed["pred_sem_cls"][i, j]), bbox_corner[i, j],
                    float(parsed["obj_prob"][i, j])) for j in idx]
        out.append(cur)
    return out


def parse_groundtruths(batch: Dict[str, np.ndarray]
                       ) -> List[List[Tuple[int, np.ndarray]]]:
    """GT list assembly from the padded labels (ap_helper.py:180-225).
    Uses the precomputed gt_box_corner_label when available."""
    corners = np.asarray(batch["gt_box_corner_label"])
    masks = np.asarray(batch["box_label_mask"])
    sem = np.asarray(batch["sem_cls_label"])
    out = []
    for i in range(corners.shape[0]):
        out.append([(int(sem[i, j]), corners[i, j])
                    for j in range(corners.shape[1]) if masks[i, j] == 1])
    return out


def _aabb_iou_1_to_many(box: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """(8,3) vs (M,8,3) -> (M,) axis-aligned IoU."""
    lo1, hi1 = box.min(0), box.max(0)
    lo2, hi2 = boxes.min(1), boxes.max(1)
    inter = np.prod(np.maximum(np.minimum(hi1, hi2) - np.maximum(lo1, lo2), 0),
                    axis=-1)
    v1 = np.prod(hi1 - lo1)
    v2 = np.prod(hi2 - lo2, axis=-1)
    return inter / (v1 + v2 - inter + 1e-8)


def voc_ap(rec: np.ndarray, prec: np.ndarray) -> float:
    """Area under the interpolated PR curve (utils/eval_det.py:21-52,
    use_07_metric=False)."""
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def eval_det_cls(pred: Dict, gt: Dict, ovthresh: float = 0.25
                 ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Single-class PR/AP (utils/eval_det.py:75-158): detections sorted by
    confidence, greedy TP matching with per-GT 'already matched' flags."""
    class_recs = {}
    npos = 0
    for img_id, boxes in gt.items():
        class_recs[img_id] = {"bbox": np.array(boxes), "det": [False] * len(boxes)}
        npos += len(boxes)
    for img_id in pred:
        if img_id not in class_recs:
            class_recs[img_id] = {"bbox": np.array([]), "det": []}

    image_ids, confidence, BB = [], [], []
    for img_id, dets in pred.items():
        for box, score in dets:
            image_ids.append(img_id)
            confidence.append(score)
            BB.append(box)
    if not image_ids:
        return np.zeros(0), np.zeros(0), 0.0
    confidence = np.asarray(confidence)
    order = np.argsort(-confidence)
    BB = np.asarray(BB)[order]
    image_ids = [image_ids[i] for i in order]

    nd = len(image_ids)
    tp = np.zeros(nd)
    fp = np.zeros(nd)
    for d in range(nd):
        R = class_recs[image_ids[d]]
        gt_boxes = R["bbox"]
        if gt_boxes.size > 0:
            ious = _aabb_iou_1_to_many(BB[d].astype(float),
                                       gt_boxes.astype(float))
            jmax = int(np.argmax(ious))
            ovmax = float(ious[jmax])
        else:
            ovmax = -np.inf
        if ovmax > ovthresh and not R["det"][jmax]:
            tp[d] = 1.0
            R["det"][jmax] = True
        else:
            fp[d] = 1.0

    fp = np.cumsum(fp)
    tp = np.cumsum(tp)
    rec = tp / float(npos + 1e-8)
    prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    return rec, prec, voc_ap(rec, prec)


def eval_det(pred_all: Dict, gt_all: Dict, ovthresh: float = 0.25):
    """Multi-class AP (utils/eval_det.py:165-253, single-process — the 18
    classes take milliseconds with the vectorized IoU)."""
    pred: Dict[int, Dict] = {}
    gt: Dict[int, Dict] = {}
    for img_id, dets in pred_all.items():
        for cls, box, score in dets:
            pred.setdefault(cls, {}).setdefault(img_id, []).append((box, score))
    for img_id, gts in gt_all.items():
        for cls, box in gts:
            gt.setdefault(cls, {}).setdefault(img_id, []).append(box)

    rec, prec, ap = {}, {}, {}
    for cls in gt:
        r, p, a = eval_det_cls(pred.get(cls, {}), gt[cls], ovthresh)
        rec[cls], prec[cls], ap[cls] = r, p, a
    return rec, prec, ap


class APCalculator:
    """Accumulates scenes then computes per-class AP/AR (ap_helper.py:225-278)."""

    def __init__(self, ap_iou_thresh: float = 0.25,
                 class2type_map: Optional[Dict] = None):
        self.ap_iou_thresh = ap_iou_thresh
        self.class2type_map = class2type_map or SCANNET_CLASS2TYPE
        self.reset()

    def step(self, batch_pred_map_cls, batch_gt_map_cls):
        assert len(batch_pred_map_cls) == len(batch_gt_map_cls)
        for p, g in zip(batch_pred_map_cls, batch_gt_map_cls):
            self.pred_map_cls[self.scan_cnt] = p
            self.gt_map_cls[self.scan_cnt] = g
            self.scan_cnt += 1

    def compute_metrics(self) -> Dict[str, float]:
        rec, prec, ap = eval_det(self.pred_map_cls, self.gt_map_cls,
                                 ovthresh=self.ap_iou_thresh)
        ret = {}
        for key in sorted(ap.keys()):
            name = self.class2type_map.get(key, str(key))
            ret[f"{name} Average Precision"] = ap[key]
        ret["mAP"] = float(np.mean(list(ap.values()))) if ap else 0.0
        rec_list = []
        for key in sorted(ap.keys()):
            name = self.class2type_map.get(key, str(key))
            last = rec[key][-1] if len(rec[key]) else 0.0
            ret[f"{name} Recall"] = float(last)
            rec_list.append(float(last))
        ret["AR"] = float(np.mean(rec_list)) if rec_list else 0.0
        return ret

    def reset(self):
        self.gt_map_cls = {}
        self.pred_map_cls = {}
        self.scan_cnt = 0
