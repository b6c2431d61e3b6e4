"""Total loss assembly (counterpart of ``scan2cap_tpu/losses/total.py:26-112``;
reference lib/loss_helper.py:381-491).

loss = 10 * (vote + 0.5*objectness + box + 0.1*sem_cls) [+ cap]
       [+ 0.1*orientation] [+ 0.1*distance]
where box = center + 0.1*heading_cls + heading_reg + 0.1*size_cls + size_reg.
Without detection, loss = cap [+ 0.1*ori] [+ 0.1*dist].
The object-centric track's loss is cls + cap (``get_object_cap_loss``).

Under a mesh (``parallel.mesh``) each batch-wide denominator is taken over
the data group (``batch_sum``) while the numerators stay local: a rank's
loss is its share of the global loss.
"""

from __future__ import annotations

import torch

from scan2cap_torch.losses.caption import (compute_cap_loss,
                                           compute_node_distance_loss,
                                           compute_node_orientation_loss)
from scan2cap_torch.losses.detection import (_ce_logits,
                                             compute_box_and_sem_cls_loss,
                                             compute_objectness_loss,
                                             compute_vote_loss)
from scan2cap_torch.parallel.mesh import batch_count, batch_mean, batch_sum

DETECTION_TERMS = ("vote_loss", "objectness_loss", "center_loss",
                   "heading_cls_loss", "heading_reg_loss", "size_cls_loss",
                   "size_reg_loss", "sem_cls_loss", "box_loss")


def get_scene_cap_loss(data_dict: dict, detection: bool = True,
                       caption: bool = True, orientation: bool = False,
                       distance: bool = False, num_bins: int = 6,
                       num_heading_bin: int = 1,
                       num_size_cluster: int = 18) -> dict:
    d = dict(data_dict)
    zero = torch.zeros((), dtype=torch.float32,
                       device=d["objectness_scores"].device)

    vote_loss = compute_vote_loss(d)
    (objectness_loss, objectness_label, objectness_mask,
     object_assignment) = compute_objectness_loss(d)
    d["objectness_label"] = objectness_label
    d["objectness_mask"] = objectness_mask
    d["object_assignment"] = object_assignment
    total = batch_count(objectness_label.shape[0]
                        * objectness_label.shape[1])
    d["pos_ratio"] = torch.sum(objectness_label.to(torch.float32)) / total
    d["neg_ratio"] = torch.sum(objectness_mask) / total - d["pos_ratio"]

    (center_loss, heading_cls_loss, heading_reg_loss, size_cls_loss,
     size_reg_loss, sem_cls_loss) = compute_box_and_sem_cls_loss(
        d, num_heading_bin, num_size_cluster)
    box_loss = (center_loss + 0.1 * heading_cls_loss + heading_reg_loss
                + 0.1 * size_cls_loss + size_reg_loss)

    obj_pred = torch.argmax(d["objectness_scores"].detach(), dim=2)
    d["obj_acc"] = (torch.sum(
        (obj_pred == objectness_label).to(torch.float32) * objectness_mask)
        / (batch_sum(torch.sum(objectness_mask)) + 1e-6))

    terms = (vote_loss, objectness_loss, center_loss, heading_cls_loss,
             heading_reg_loss, size_cls_loss, size_reg_loss, sem_cls_loss,
             box_loss)
    for k, v in zip(DETECTION_TERMS, terms):
        d[k] = v if detection else zero

    if caption:
        d["cap_loss"], d["cap_acc"] = compute_cap_loss(d)
    else:
        d["cap_loss"], d["cap_acc"] = zero, zero
        d["pred_ious"] = zero

    if orientation:
        d["ori_loss"], d["ori_acc"] = compute_node_orientation_loss(d, num_bins)
    else:
        d["ori_loss"], d["ori_acc"] = zero, zero

    d["dist_loss"] = compute_node_distance_loss(d) if distance else zero

    if detection:
        loss = (d["vote_loss"] + 0.5 * d["objectness_loss"] + d["box_loss"]
                + 0.1 * d["sem_cls_loss"])
        loss = loss * 10.0                     # amplify (loss_helper.py:469-470)
        if caption:
            loss = loss + d["cap_loss"]
    else:
        loss = d["cap_loss"]
    if orientation:
        loss = loss + 0.1 * d["ori_loss"]
    if distance:
        loss = loss + 0.1 * d["dist_loss"]

    d["loss"] = loss
    return d


def compute_object_cls_loss(data_dict: dict, weights=None):
    """Object classification loss of the object-centric track
    (loss_helper.py:357-379): CE of ``enc_preds`` against ``object_cat``,
    weighted by class when ``weights`` is given.  Returns (loss, acc)."""
    preds = data_dict["enc_preds"]                  # (B, num_cls)
    targets = data_dict["object_cat"].long()
    ce = _ce_logits(preds, targets)
    if weights is not None:
        w = torch.as_tensor(weights, dtype=preds.dtype,
                            device=preds.device)[targets]
        cls_loss = torch.sum(ce * w) / batch_sum(torch.sum(w))
    else:
        cls_loss = batch_mean(ce)
    acc = batch_mean((torch.argmax(preds.detach(), -1) == targets).to(
        torch.float32))
    return cls_loss, acc


def get_object_cap_loss(data_dict: dict, weights=None, classify: bool = True,
                        caption: bool = True) -> dict:
    """Object-centric total loss (loss_helper.py:493-532):
    loss = cls + cap."""
    d = dict(data_dict)
    zero = torch.zeros((), dtype=torch.float32, device=d[
        "enc_preds" if classify else "lang_cap"].device)
    if classify:
        d["cls_loss"], d["cls_acc"] = compute_object_cls_loss(d, weights)
    else:
        d["cls_loss"], d["cls_acc"] = zero, zero
    if caption:
        d["cap_loss"], d["cap_acc"] = compute_cap_loss(d)
    else:
        d["cap_loss"], d["cap_acc"] = zero, zero
    d["loss"] = d["cls_loss"] + d["cap_loss"]
    return d
