"""Hungarian matching of set predictions to ground-truth boxes (3DETR's
``criterion.Matcher``), every decoder layer's own.

The cost of query q for GT box g is ``cls_cost * -p(class of g) +
giou_cost * -gIoU(q, g)`` (3DETR's defaults 1 and 2, its centre and
objectness costs 0).  All layers' cost matrices are computed on the
device, copied to the host with the scenes' GT counts in one transfer,
and ``scipy.optimize.linear_sum_assignment`` runs once per (layer,
scene) over that scene's real boxes.  The assignment, with the last
layer's matched (scene, query, GT box) triples, returns to the device in
one transfer.  The whole matching is the ``scan2cap.match``
span, and its host seconds are appended to ``MATCH_RECORD``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from scan2cap_torch.ops.boxes import generalized_iou_aabb
from scan2cap_torch.utils.profiling import (MATCH_RECORD, MatchEntry,
                                            annotate, profiling)


def match_costs(sem_cls_prob: torch.Tensor, center: torch.Tensor,
                size: torch.Tensor, gt_class: torch.Tensor,
                gt_center: torch.Tensor, gt_size: torch.Tensor,
                cls_cost: float = 1.0, giou_cost: float = 2.0
                ) -> torch.Tensor:
    """Predictions (L, B, Q, C) class probabilities without no-object,
    (L, B, Q, 3) centres and sizes; GT (B, M) classes, (B, M, 3) centres
    and sizes -> (L, B, Q, M) costs."""
    L, B, Q, C = sem_cls_prob.shape
    M = gt_class.shape[1]
    cls = gt_class.long().clamp(0, C - 1)[None, :, None, :].expand(L, B, Q, M)
    prob = torch.gather(sem_cls_prob, 3, cls)
    giou = generalized_iou_aabb(center, size, gt_center[None], gt_size[None])
    return cls_cost * -prob + giou_cost * -giou


def assign(cost: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """(L, B, Q, M) costs, (B,) GT counts -> (L, B, Q) int64: the GT box
    each query is matched to, -1 where none."""
    from scipy.optimize import linear_sum_assignment
    L, B, Q, _ = cost.shape
    out = np.full((L, B, Q), -1, dtype=np.int64)
    for layer in range(L):
        for b in range(B):
            n = int(counts[b])
            if n:
                rows, cols = linear_sum_assignment(cost[layer, b, :, :n])
                out[layer, b, rows] = cols
    return out


def hungarian(sem_cls_prob: torch.Tensor, center: torch.Tensor,
              size: torch.Tensor, gt_class: torch.Tensor,
              gt_center: torch.Tensor, gt_size: torch.Tensor,
              gt_mask: torch.Tensor, cls_cost: float = 1.0,
              giou_cost: float = 2.0):
    """The assignment (L, B, Q) int64 on the predictions' device of every
    layer (``match_costs``), and the last layer's matches (3, N) int64:
    scene, query and GT box, by scene and query.  ``gt_mask`` (B, M)
    marks the real boxes, which come first in each scene."""
    t0 = time.perf_counter()
    traced = profiling()
    with annotate("scan2cap.match"), torch.no_grad():
        cost = match_costs(sem_cls_prob, center, size, gt_class, gt_center,
                           gt_size, cls_cost, giou_cost)
        counts = gt_mask.float().sum(1)
        host = torch.cat([cost.reshape(-1).float(), counts]).cpu().numpy()
        out = assign(host[:cost.numel()].reshape(cost.shape),
                     np.rint(host[cost.numel():]))
        b, q = np.nonzero(out[-1] >= 0)
        flat = torch.from_numpy(np.concatenate(
            [out.ravel(), b, q, out[-1][b, q]])).to(center.device)
    MATCH_RECORD.append(MatchEntry(time.perf_counter() - t0, traced))
    return (flat[:out.size].view(out.shape),
            flat[out.size:].view(3, len(b)))
