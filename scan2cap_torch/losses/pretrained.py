"""Pretrained-track losses (counterpart of
``scan2cap_tpu/losses/pretrained.py:21-71``; reference
lib/loss_helper_pretrained.py).

"gt" mode: plain token CE averaged over the non-pad tokens (torch
CrossEntropyLoss(ignore_index=0) mean reduction, :26-42); "votenet" mode:
the IoU-gated CE of the scene path (:43-77).  Total =
cap + 0.1 * orientation [+ 0.1 * distance] (:167-204).  Under a mesh
the denominators and the batch-max caption length are the global batch's
(``parallel.mesh``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from scan2cap_torch.losses.caption import (compute_cap_loss,
                                           compute_node_distance_loss,
                                           compute_node_orientation_loss)
from scan2cap_torch.losses.detection import _ce_logits
from scan2cap_torch.parallel.mesh import batch_max, batch_sum


def compute_cap_loss_gt(data_dict: dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean CE over the non-pad target tokens (gt mode).  Returns
    (cap_loss, cap_acc)."""
    pred_caps = data_dict["lang_cap"]                   # (B, T, V)
    num_words = batch_max(torch.max(data_dict["lang_len"]))
    T = pred_caps.shape[1]
    targets = data_dict["lang_ids"][:, 1:T + 1].long()

    steps = torch.arange(T, device=pred_caps.device)[None, :]
    step_mask = (steps < (num_words - 1)).to(torch.float32)
    pad_mask = (targets != 0).to(torch.float32) * step_mask

    ce = _ce_logits(pred_caps, targets) * pad_mask
    denom = batch_sum(torch.sum(pad_mask)) + 1e-6
    cap_loss = torch.sum(ce) / denom

    preds = torch.argmax(pred_caps.detach(), dim=-1)
    cap_acc = (torch.sum((preds == targets).to(torch.float32) * pad_mask)
               / denom)
    return cap_loss, cap_acc


def get_pretrained_loss(data_dict: dict, mode: str = "gt",
                        orientation: bool = False, distance: bool = False,
                        num_bins: int = 6) -> dict:
    d = dict(data_dict)
    zero = torch.zeros((), dtype=torch.float32,
                       device=d["lang_cap"].device)
    if mode == "gt":
        cap_loss, cap_acc = compute_cap_loss_gt(d)
    else:
        cap_loss, cap_acc = compute_cap_loss(d)
    d["cap_loss"], d["cap_acc"] = cap_loss, cap_acc

    if orientation:
        # the stored boxes carry their object ids directly: the rotation
        # labels are already box-aligned, so each box is its own object
        if "object_assignment" not in d:
            B, K = d["bbox_mask"].shape
            d["object_assignment"] = torch.arange(
                K, dtype=torch.int32, device=zero.device)[None].expand(B, K)
        d["ori_loss"], d["ori_acc"] = compute_node_orientation_loss(
            d, num_bins)
    else:
        d["ori_loss"], d["ori_acc"] = zero, zero

    d["dist_loss"] = compute_node_distance_loss(d) if distance else zero

    loss = cap_loss + 0.1 * d["ori_loss"]
    if distance:
        loss = loss + 0.1 * d["dist_loss"]
    d["loss"] = loss
    return d
