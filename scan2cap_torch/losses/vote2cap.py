"""Vote2Cap-DETR's loss: 3DETR's set criterion (``criterion.py``,
``SetCriterion.single_output_forward``) over every decoder layer's own
assignment, summed over the layers, plus VoteNet's vote loss on the
encoder tokens and the caption's token-mean cross entropy.

Per layer: the class cross entropy over every query (no-object for an
unmatched one, its weight ``noobj_weight``; the weighted mean), the L1 of
the matched queries' normalised centres and sizes against their GT
boxes', and the Huber loss of the matched queries' normalised angle
residuals, each summed and divided by the batch's GT boxes.  ScanNet's
boxes are axis-aligned, so every GT angle is bin 0 with residual 0; the
angle class term, a cross entropy over the one bin, is 0 with a zero
gradient and is left out.
"""

from __future__ import annotations

from typing import Dict

import torch

from scan2cap_torch.config import Vote2CapConfig
from scan2cap_torch.losses.detection import compute_vote_loss
from scan2cap_torch.models.vote2cap import gt_boxes
from scan2cap_torch.ops.nn_distance import huber_loss
from scan2cap_torch.parallel.mesh import batch_sum


def _ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels[..., None])[..., 0]


def set_loss(d: Dict, mean_size: torch.Tensor, v: Vote2CapConfig) -> Dict:
    """The summed criterion of all layers and its parts."""
    gt_cls, gt_center, gt_size, gt_mask = gt_boxes(d, mean_size)
    lo, hi = d["scene_lo"], d["scene_hi"]
    scale = (hi - lo)[:, None]
    gt_center_n = (gt_center - lo[:, None]) / scale         # (B, M, 3)
    gt_size_n = gt_size / scale
    assignment = d["assignment"]                            # (L, B, Q)
    matched = assignment >= 0
    gt = assignment.clamp(min=0)
    logits = d["sem_cls_logits"]                            # (L, B, Q, C+1)
    noobj = logits.shape[-1] - 1
    L = logits.shape[0]
    rows = gt_cls.long()[None].expand(L, -1, -1)
    target = torch.where(matched, torch.gather(rows, 2, gt), noobj)
    weight = torch.where(target == noobj, v.noobj_weight, 1.0)
    cls_loss = (torch.sum(_ce(logits, target) * weight, dim=(1, 2))
                / torch.sum(weight, dim=(1, 2)))
    num_boxes = torch.clamp(batch_sum(gt_mask.float().sum()), min=1.0)

    def l1(pred, want):
        w = torch.gather(want[None].expand(L, -1, -1, -1), 2,
                         gt[..., None].expand(-1, -1, -1, 3))
        return (torch.sum(torch.abs(pred - w).sum(-1) * matched, dim=(1, 2))
                / num_boxes)

    center_loss = l1(d["center_normalized"], gt_center_n)
    size_loss = l1(d["size_normalized"], gt_size_n)
    angle_loss = (torch.sum(huber_loss(d["angle_residual"][..., 0]) * matched,
                            dim=(1, 2)) / num_boxes)
    per_layer = (cls_loss + v.loss_center_weight * center_loss
                 + v.loss_size_weight * size_loss
                 + v.loss_angle_reg_weight * angle_loss)
    return dict(set_loss=per_layer.sum(), sem_cls_loss=cls_loss.sum(),
                center_loss=center_loss.sum(), size_loss=size_loss.sum(),
                angle_loss=angle_loss.sum())


def caption_loss(d: Dict) -> Dict:
    """Token-mean cross entropy of the teacher-forced captions, and the
    share of their tokens predicted right."""
    logits, target = d["cap_logits"], d["cap_target"].long()
    mask = (target != 0).float()
    count = torch.clamp(batch_sum(mask.sum()), min=1.0)
    loss = torch.sum(_ce(logits, target) * mask) / count
    right = (logits.detach().argmax(-1) == target).float()
    return dict(cap_loss=loss, cap_acc=torch.sum(right * mask) / count)


def get_vote2cap_loss(d: Dict, mean_size: torch.Tensor,
                      v: Vote2CapConfig) -> Dict:
    """``d`` with ``loss`` and its parts."""
    out = dict(d)
    out.update(set_loss(d, mean_size, v))
    out["vote_loss"] = compute_vote_loss(out)
    out.update(caption_loss(d))
    out["loss"] = (out["set_loss"] + v.loss_vote_weight * out["vote_loss"]
                   + v.loss_caption_weight * out["cap_loss"])
    return out
