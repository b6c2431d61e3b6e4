"""Caption + graph-edge losses (counterpart of
``scan2cap_tpu/losses/caption.py:24-126``; reference
lib/loss_helper.py:189-355).

Static shapes: the decoder always runs ``max_des_len + 1`` steps, so the
caption CE masks the steps beyond the batch-max caption length (the
reference truncates the loop instead: same objective, the denominator
counts (good box x step) pairs including pads, and pad targets contribute
zero loss via ignore_index=0).  The edge losses work on the dense
(B, K, L) edge list with ``edge_mask``.

Under a mesh (``parallel.mesh``) each batch-wide denominator is taken over
the data group (``batch_sum``) while the numerators stay local: a rank's
loss is its share of the global loss.  The batch-max caption length is
the global one (``batch_max``).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from scan2cap_torch.losses.detection import _ce_logits
from scan2cap_torch.parallel.mesh import batch_max, batch_sum


def compute_cap_loss(data_dict: dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token CE (ignore pad=0) gated by good_bbox_masks
    (loss_helper.py:189-230).  Returns (cap_loss, cap_acc)."""
    pred_caps = data_dict["lang_cap"]                   # (B, T-1, V)
    num_words = batch_max(torch.max(data_dict["lang_len"]))  # batch-max
    T = pred_caps.shape[1]
    targets = data_dict["lang_ids"][:, 1:T + 1].long()  # (B, T)

    steps = torch.arange(T, device=pred_caps.device)[None, :]
    step_mask = (steps < (num_words - 1)).to(torch.float32)
    pad_mask = (targets != 0).to(torch.float32)
    good = data_dict["good_bbox_masks"].to(torch.float32)[:, None]  # (B, 1)

    ce = _ce_logits(pred_caps, targets) * pad_mask      # ignore_index=0
    denom = batch_sum(torch.sum(good * step_mask)) + 1e-6  # pads counted
    cap_loss = torch.sum(ce * good * step_mask) / denom

    # accuracy over non-pad tokens of good boxes
    preds = torch.argmax(pred_caps.detach(), dim=-1)
    correct_mask = pad_mask * good * step_mask
    num_good = batch_sum(torch.sum(data_dict["good_bbox_masks"]))
    acc = (torch.sum((preds == targets).to(torch.float32) * correct_mask)
           / (batch_sum(torch.sum(correct_mask)) + 1e-6))
    cap_acc = torch.where(num_good > 0, acc, torch.zeros_like(acc))
    return cap_loss, cap_acc


def radian_to_label(radians: torch.Tensor, num_bins: int = 6) -> torch.Tensor:
    """Discretise [0, pi] rotation angles into ``num_bins`` classes
    (loss_helper.py:232-247).  ``torch.bucketize(right=False)`` returns the
    first boundary index >= x (searchsorted side='left'): an angle exactly
    on a bin edge k*pi/num_bins belongs to class k, not k+1."""
    boundaries = torch.as_tensor(
        np.arange(math.pi / num_bins, math.pi - 1e-8, math.pi / num_bins
                  ).astype(np.float32), device=radians.device)
    return torch.bucketize(radians.to(torch.float32), boundaries,
                           right=False).to(torch.int32)


def _edge_endpoint_gather(x: torch.Tensor, assignment: torch.Tensor,
                          nbr_idx: torch.Tensor):
    """Per-proposal labels for edge sources (rows) and targets (neighbours).

    x (B, M, ...) indexed by GT object; assignment (B, K); nbr_idx
    (B, K, L).  Returns (src (B, K, 1, ...), tgt (B, K, L, ...))."""
    B, K, L = nbr_idx.shape
    assignment = assignment.long()
    tgt_obj = torch.gather(assignment, 1, nbr_idx.reshape(B, K * L).long()
                           ).reshape(B, K, L)
    rows = torch.arange(B, device=x.device)[:, None]

    def take(obj_idx):
        out = x[rows, obj_idx.reshape(B, -1)]
        return out.reshape(obj_idx.shape + x.shape[2:])

    return take(assignment[..., None]), take(tgt_obj)


def compute_node_orientation_loss(data_dict: dict, num_bins: int = 6
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """CE over relative-rotation bins per edge (loss_helper.py:249-313)."""
    assignment = data_dict["object_assignment"]         # (B, K)
    nbr_idx = data_dict["edge_nbr_idx"]                 # (B, K, L)
    edge_mask = data_dict["edge_mask"]                  # (B, K, L)
    preds = data_dict["edge_orientations"]              # (B, K, L, bins)

    rot = data_dict["scene_object_rotations"]           # (B, M, 3, 3)
    rot_mask = data_dict["scene_object_rotation_masks"].to(torch.float32)

    src_rot, tgt_rot = _edge_endpoint_gather(rot, assignment, nbr_idx)
    src_m, tgt_m = _edge_endpoint_gather(rot_mask, assignment, nbr_idx)

    rel = torch.einsum("bklij,bklmj->bklim", src_rot.expand_as(tgt_rot),
                       tgt_rot)
    trace = rel[..., 0, 0] + rel[..., 1, 1] + rel[..., 2, 2]
    angle = torch.arccos(torch.clamp(0.5 * (trace - 1.0), -1.0, 1.0))

    labels = radian_to_label(angle, num_bins)
    masks = src_m.expand_as(tgt_m) * tgt_m * edge_mask

    ce = _ce_logits(preds, labels)
    denom = batch_sum(torch.sum(masks)) + 1e-8
    loss = torch.sum(ce * masks) / denom
    hits = (torch.argmax(preds.detach(), dim=-1) == labels).to(torch.float32)
    acc = torch.sum(hits * masks) / denom
    return loss, acc


def compute_node_distance_loss(data_dict: dict) -> torch.Tensor:
    """MSE of predicted vs GT centre distance per edge
    (loss_helper.py:315-355), averaged over the real edges."""
    assignment = data_dict["object_assignment"]
    nbr_idx = data_dict["edge_nbr_idx"]
    edge_mask = data_dict["edge_mask"]
    preds = data_dict["edge_distances"]                 # (B, K, L)

    gt_center = data_dict["center_label"][:, :, 0:3]
    src_c, tgt_c = _edge_endpoint_gather(gt_center, assignment, nbr_idx)
    labels = torch.linalg.vector_norm(src_c.expand_as(tgt_c) - tgt_c, dim=-1)
    sq = (preds - labels) ** 2
    return torch.sum(sq * edge_mask) / (batch_sum(torch.sum(edge_mask))
                                        + 1e-8)
