"""Detection losses (counterpart of ``scan2cap_tpu/losses/detection.py:30-143``;
reference lib/loss_helper.py:24-187, VoteNet).

Constants (loss_helper.py:19-22): NEAR 0.3 m / FAR 0.6 m objectness
thresholds, CE class weights [0.2, 0.8], 3 identical GT votes per point.

Under a mesh (``parallel.mesh``) each batch-wide denominator is taken over
the data group (``batch_sum``) while the numerators stay local: a rank's
loss is its share of the global loss.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from scan2cap_torch.config import SCANNET_MEAN_SIZE_ARR
from scan2cap_torch.ops.nn_distance import huber_loss, nn_distance
from scan2cap_torch.parallel.mesh import batch_sum

FAR_THRESHOLD = 0.6
NEAR_THRESHOLD = 0.3
GT_VOTE_FACTOR = 3
OBJECTNESS_CLS_WEIGHTS = (0.2, 0.8)

# SCANNET_MEAN_SIZE_ARR by (device, dtype), made at its first use: a
# tensor made from the host each call would be a copy to the card and a
# synchronisation, which no CUDA graph capture allows
_MEAN_SIZES: Dict[tuple, torch.Tensor] = {}


def _mean_sizes(like: torch.Tensor) -> torch.Tensor:
    if torch.compiler.is_compiling():           # a tracer's tensors
        return like.new_tensor(SCANNET_MEAN_SIZE_ARR)
    key = (like.device, like.dtype)
    if key not in _MEAN_SIZES:
        # a plain tensor, also when made under inference_mode
        with torch.inference_mode(False):
            _MEAN_SIZES[key] = like.new_tensor(SCANNET_MEAN_SIZE_ARR)
    return _MEAN_SIZES[key]


def _ce_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-element cross entropy from raw logits (CrossEntropyLoss,
    reduction='none'); labels index the trailing axis."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels.long()[..., None])[..., 0]


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, M, ...), idx (B, K) -> (B, K, ...): rows of axis 1.  The index
    is broadcast over the trailing axes as a view (``expand``), never
    repeated, so the gather stays a row gather."""
    idx = idx.long().reshape(idx.shape + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, idx.expand(idx.shape[:2] + x.shape[2:]))


def compute_vote_loss(data_dict: dict) -> torch.Tensor:
    """Min-of-min L1 chamfer between predicted votes and gathered GT votes
    (loss_helper.py:24-69)."""
    seed_xyz = data_dict["seed_xyz"]                    # (B, S, 3)
    B, S, _ = seed_xyz.shape
    vote_xyz = data_dict["vote_xyz"]                    # (B, S*vf, 3)
    seed_inds = data_dict["seed_inds"]

    seed_gt_votes_mask = _take(
        data_dict["vote_label_mask"].to(torch.float32), seed_inds)
    seed_gt_votes = _take(data_dict["vote_label"], seed_inds)
    seed_gt_votes = seed_gt_votes + seed_xyz.repeat(1, 1, GT_VOTE_FACTOR)

    vf = vote_xyz.shape[1] // S
    vote_r = vote_xyz.reshape(B * S, vf, 3)
    gt_r = seed_gt_votes.reshape(B * S, GT_VOTE_FACTOR, 3)
    _, _, dist2, _ = nn_distance(vote_r, gt_r, l1=True)
    votes_dist = torch.amin(dist2, dim=1).reshape(B, S)
    return (torch.sum(votes_dist * seed_gt_votes_mask)
            / (batch_sum(torch.sum(seed_gt_votes_mask)) + 1e-6))


def compute_objectness_loss(data_dict: dict
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor, torch.Tensor]:
    """Proposal-to-GT centre assignment + weighted objectness CE
    (loss_helper.py:71-111).  Returns (loss, label int32, mask float32,
    assignment int32)."""
    agg_xyz = data_dict["aggregated_vote_xyz"]          # (B, K, 3)
    gt_center = data_dict["center_label"][:, :, 0:3]    # (B, K2, 3)
    dist1, ind1, _, _ = nn_distance(agg_xyz, gt_center)

    euclid = torch.sqrt(dist1.detach() + 1e-6)
    near = euclid < NEAR_THRESHOLD
    objectness_label = near.to(torch.int32)
    objectness_mask = (near | (euclid > FAR_THRESHOLD)).to(torch.float32)

    scores = data_dict["objectness_scores"]             # (B, K, 2)
    # the class weights as fills: a tensor of them made on the host would
    # be a copy to the card each call
    w = torch.where(near, OBJECTNESS_CLS_WEIGHTS[1],
                    OBJECTNESS_CLS_WEIGHTS[0]).to(scores.dtype)
    ce = _ce_logits(scores, objectness_label) * w
    loss = (torch.sum(ce * objectness_mask)
            / (batch_sum(torch.sum(objectness_mask)) + 1e-6))
    return loss, objectness_label, objectness_mask, ind1


def compute_box_and_sem_cls_loss(data_dict: dict, num_heading_bin: int = 1,
                                 num_size_cluster: int = 18):
    """Centre chamfer + heading/size cls+reg + sem cls, objectness-masked
    (loss_helper.py:113-187).  Returns the 6 loss terms."""
    assignment = data_dict["object_assignment"].long()  # (B, K)
    objness = data_dict["objectness_label"].to(torch.float32)
    denom_obj = batch_sum(torch.sum(objness)) + 1e-6

    # centre: bidirectional chamfer
    pred_center = data_dict["center"]
    gt_center = data_dict["center_label"][:, :, 0:3]
    dist1, _, dist2, _ = nn_distance(pred_center, gt_center)
    box_label_mask = data_dict["box_label_mask"].to(torch.float32)
    center_loss = (torch.sum(dist1 * objness) / denom_obj
                   + torch.sum(dist2 * box_label_mask)
                   / (batch_sum(torch.sum(box_label_mask)) + 1e-6))

    # heading
    heading_cls_label = _take(data_dict["heading_class_label"], assignment)
    heading_cls_loss = torch.sum(
        _ce_logits(data_dict["heading_scores"], heading_cls_label) * objness
    ) / denom_obj
    heading_res_label = _take(
        data_dict["heading_residual_label"].to(torch.float32), assignment)
    heading_res_norm_label = heading_res_label / (math.pi / num_heading_bin)
    heading_onehot = torch.nn.functional.one_hot(
        heading_cls_label.long(), num_heading_bin).to(torch.float32)
    pred_heading_res = torch.sum(
        data_dict["heading_residuals_normalized"] * heading_onehot, dim=-1)
    heading_reg_loss = torch.sum(
        huber_loss(pred_heading_res - heading_res_norm_label, 1.0) * objness
    ) / denom_obj

    # size
    size_cls_label = _take(data_dict["size_class_label"], assignment)
    size_cls_loss = torch.sum(
        _ce_logits(data_dict["size_scores"], size_cls_label) * objness
    ) / denom_obj
    size_res_label = _take(data_dict["size_residual_label"], assignment)
    size_onehot = torch.nn.functional.one_hot(
        size_cls_label.long(), num_size_cluster).to(torch.float32)
    pred_size_res = torch.sum(
        data_dict["size_residuals_normalized"] * size_onehot[..., None], dim=2)
    mean_sizes = _mean_sizes(pred_size_res)
    mean_size_label = mean_sizes[size_cls_label.long()]  # (B, K, 3)
    size_res_label_norm = size_res_label / mean_size_label
    size_reg = torch.mean(
        huber_loss(pred_size_res - size_res_label_norm, 1.0), dim=-1)
    size_reg_loss = torch.sum(size_reg * objness) / denom_obj

    # semantic class
    sem_cls_label = _take(data_dict["sem_cls_label"], assignment)
    sem_cls_loss = torch.sum(
        _ce_logits(data_dict["sem_cls_scores"], sem_cls_label) * objness
    ) / denom_obj

    return (center_loss, heading_cls_loss, heading_reg_loss,
            size_cls_loss, size_reg_loss, sem_cls_loss)
