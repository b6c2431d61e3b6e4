"""Greedy AABB NMS (counterpart of ``scan2cap_tpu/ops/nms.py:23-92``;
reference utils/nms.py:28-151, ``old_type=False``).

Boxes are visited in descending-score order; a box survives iff no
earlier surviving box overlaps it above the threshold (class-aware NMS:
and has the same class).  The work splits in two:

* on the input's device, in one pass of batched ops: the rank order and
  the (B, K, K) suppression matrix in rank space, ``sup[b, e, r]`` = the
  box of rank ``e`` would suppress the later box of rank ``r``;
* on the host: one copy of that bool matrix (128 KB at B=2, K=256) and the
  greedy pass over the K ranks in numpy, vectorised over the batch.

The greedy pass is sequential over the ranks; written as device ops it
would be K small launches per call.  The caller syncs for the mask anyway.

Tie order: the reference sorts ascending and pops from the end, so among
exactly tied scores the HIGHER proposal index is visited (and kept) first;
a stable sort of the reversed scores gives that order.
"""

from __future__ import annotations

import numpy as np
import torch


def _aabb_iou_matrix(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """lo/hi (..., K, 3) -> (..., K, K) IoU.  The three extents multiply as
    ``(x*y)*z``, the order in which XLA reduces ``prod`` on the CPU, so
    ``iou > threshold`` decides as the JAX package does."""
    inter_lo = torch.maximum(lo[..., :, None, :], lo[..., None, :, :])
    inter_hi = torch.minimum(hi[..., :, None, :], hi[..., None, :, :])
    e = torch.clamp(inter_hi - inter_lo, min=0.0)
    inter = (e[..., 0] * e[..., 1]) * e[..., 2]
    s = hi - lo
    vol = (s[..., 0] * s[..., 1]) * s[..., 2]
    return inter / (vol[..., :, None] + vol[..., None, :] - inter + 1e-8)


def suppression_matrix(corners: torch.Tensor, scores: torch.Tensor,
                       classes: torch.Tensor, iou_threshold: float,
                       same_cls: bool):
    """corners (B, K, 8, 3), scores (B, K), classes (B, K) -> the rank
    order (B, K) int64 (``order[b, r]`` is the proposal of rank r) and the
    (B, K, K) bool matrix ``sup[b, e, r]``: rank e is earlier than rank r
    and overlaps it above the threshold."""
    B, K = scores.shape
    order = (K - 1) - torch.argsort(-scores.flip(-1), dim=-1, stable=True)
    ranked = torch.gather(corners, 1, order[:, :, None, None].expand(
        -1, -1, *corners.shape[2:]))
    iou = _aabb_iou_matrix(ranked.amin(dim=2), ranked.amax(dim=2))
    if same_cls:
        c = torch.gather(classes, 1, order)
        iou = iou * (c[:, :, None] == c[:, None, :])
    later = torch.ones((K, K), dtype=torch.bool,
                       device=scores.device).triu(1)     # e < r
    return order, (iou > iou_threshold) & later


def greedy_keep(order: np.ndarray, sup: np.ndarray) -> np.ndarray:
    """The greedy pass on the host: order (B, K), sup (B, K, K) as from
    ``suppression_matrix`` -> (B, K) bool keep mask in proposal order."""
    B, K = order.shape
    keep_s = np.zeros((B, K), bool)
    removed = np.zeros((B, K), bool)
    for r in range(K):
        keep_s[:, r] = ~removed[:, r]
        removed |= sup[:, r] & keep_s[:, r:r + 1]
    keep = np.zeros((B, K), bool)
    np.put_along_axis(keep, order, keep_s, axis=1)
    return keep


def nms_3d(corners: torch.Tensor, scores: torch.Tensor, classes: torch.Tensor,
           iou_threshold: float = 0.25, same_cls: bool = True) -> torch.Tensor:
    """Batched class-aware 3D NMS: corners (B, K, 8, 3), scores (B, K)
    objectness probabilities, classes (B, K) int -> (B, K) bool keep mask
    (the reference's ``pred_mask``) on the input's device."""
    order, sup = suppression_matrix(corners, scores, classes, iou_threshold,
                                    same_cls)
    keep = greedy_keep(order.cpu().numpy(), sup.cpu().numpy())
    return torch.from_numpy(keep).to(scores.device)


def nms_2d(corners: torch.Tensor, scores: torch.Tensor,
           iou_threshold: float = 0.25) -> torch.Tensor:
    """Birds-eye (x/y footprint) greedy NMS, class-agnostic
    (utils/nms.py:28-58 ``nms_2d_faster`` over the box extents):
    corners (B, K, 8, 3), scores (B, K) -> (B, K) bool keep mask."""
    flat = corners.clone()
    flat[..., 2] = 0.0                   # flatten the up axis ...
    flat[..., 0::2, 2] = 1.0             # ... to a unit height
    classes = torch.zeros(scores.shape, dtype=torch.int32,
                          device=scores.device)
    return nms_3d(flat, scores, classes, iou_threshold, same_cls=False)
