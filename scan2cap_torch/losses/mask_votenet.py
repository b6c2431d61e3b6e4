"""MaskVoteNet losses (counterpart of ``scan2cap_tpu/losses/mask_votenet.py:23-86``;
reference lib/loss_helper_maskvotenet.py).

Single-target variant: every labelled point votes to the target centre, and
the box losses are means over the single proposal (no objectness masking):
  loss = 10 * (vote + box + 0.1*sem_cls),
  box = center (sqrt of the chamfer distance, mean) + 0.1*size_cls + size_reg.
Also the mIoU between the decoded single box and the GT box, on the
device.  The objectness and heading terms are reported as zeros, so that
the solver's report keys are CapNet's.

Under a mesh (``parallel.mesh``) every mean is over the global batch
(``batch_mean``): a rank's loss is its share of the global loss.
"""

from __future__ import annotations

import torch

from scan2cap_torch.config import SCANNET_MEAN_SIZE_ARR
from scan2cap_torch.losses.detection import _ce_logits, compute_vote_loss
from scan2cap_torch.ops.boxes import box3d_iou_batch, get_3d_box_batch
from scan2cap_torch.ops.nn_distance import huber_loss, nn_distance
from scan2cap_torch.parallel.mesh import batch_mean


def compute_mask_box_loss(data_dict: dict, num_size_cluster: int = 18):
    """Centre, size class and residual, semantic class, all mean-reduced
    (loss_helper_maskvotenet.py:140-188).  Returns (center_loss,
    size_cls_loss, size_reg_loss, sem_cls_loss, sem_cls_acc)."""
    pred_center = data_dict["center"]                       # (B, 1, 3)
    gt_center = data_dict["center_label"][:, :, 0:3]        # (B, 1, 3)
    dist1, _, _, _ = nn_distance(pred_center, gt_center)
    # +1e-8: the reference's bare sqrt has an unbounded gradient at zero
    # distance
    center_loss = batch_mean(torch.sqrt(dist1 + 1e-8))

    size_cls_label = data_dict["size_class_label"].long()   # (B, 1)
    size_cls_loss = batch_mean(
        _ce_logits(data_dict["size_scores"], size_cls_label))

    size_onehot = torch.nn.functional.one_hot(
        size_cls_label, num_size_cluster).to(torch.float32)
    pred_res = torch.sum(
        data_dict["size_residuals_normalized"] * size_onehot[..., None], dim=2)
    mean_sizes = pred_res.new_tensor(SCANNET_MEAN_SIZE_ARR)
    res_label_norm = (data_dict["size_residual_label"]
                      / mean_sizes[size_cls_label])
    size_reg_loss = batch_mean(huber_loss(pred_res - res_label_norm, 1.0))

    sem_label = data_dict["sem_cls_label"].long()
    sem_scores = data_dict["sem_cls_scores"]
    sem_cls_loss = batch_mean(_ce_logits(sem_scores, sem_label))
    sem_cls_acc = batch_mean(
        (torch.argmax(sem_scores.detach(), -1) == sem_label).to(torch.float32))
    return center_loss, size_cls_loss, size_reg_loss, sem_cls_loss, sem_cls_acc


@torch.no_grad()
def compute_miou(data_dict: dict) -> torch.Tensor:
    """Mean IoU of the decoded single proposal against the GT box, on the
    device (a metric: no gradient)."""
    pred_center = data_dict["center"][:, 0]                 # (B, 3)
    size_cls = torch.argmax(data_dict["size_scores"], -1)    # (B, 1)
    size_res = torch.gather(
        data_dict["size_residuals"], 2,
        size_cls[..., None, None].expand(-1, -1, 1, 3))[:, 0, 0]
    mean_sizes = pred_center.new_tensor(SCANNET_MEAN_SIZE_ARR)
    box_size = mean_sizes[size_cls[:, 0]] + size_res
    heading = pred_center.new_zeros(pred_center.shape[:1])
    pred_corners = get_3d_box_batch(box_size, heading, pred_center)
    return batch_mean(box3d_iou_batch(pred_corners,
                                      data_dict["bbox_corner_label"]))


def get_mask_votenet_loss(data_dict: dict, num_size_cluster: int = 18) -> dict:
    d = dict(data_dict)
    zero = torch.zeros((), dtype=torch.float32, device=d["center"].device)
    d["vote_loss"] = compute_vote_loss(d)
    (center_loss, size_cls_loss, size_reg_loss,
     sem_cls_loss, sem_cls_acc) = compute_mask_box_loss(d, num_size_cluster)
    box_loss = center_loss + 0.1 * size_cls_loss + size_reg_loss
    d["objectness_loss"] = zero
    d["center_loss"] = center_loss
    d["heading_cls_loss"] = zero
    d["heading_reg_loss"] = zero
    d["size_cls_loss"] = size_cls_loss
    d["size_reg_loss"] = size_reg_loss
    d["sem_cls_loss"] = sem_cls_loss
    d["box_loss"] = box_loss
    d["sem_cls_acc"] = sem_cls_acc
    if "bbox_corner_label" in d:
        d["miou"] = compute_miou(d)
    loss = (d["vote_loss"] + 0.5 * d["objectness_loss"] + box_loss
            + 0.1 * sem_cls_loss)
    d["loss"] = loss * 10.0
    return d
