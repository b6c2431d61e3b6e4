"""The losses of the reference (VoteNet detection, caption, edge
orientation; MaskVoteNet's single-box loss): a frozen copy of the
arithmetic of ``scan2cap_torch.losses`` on one process."""

from __future__ import annotations

import torch

from h100bench.reference import ops

NEAR, FAR = 0.3, 0.6
OBJECTNESS_WEIGHTS = (0.2, 0.8)


def vote_loss(d):
    seed_xyz, vote_xyz = d["seed_xyz"], d["vote_xyz"]
    B, S, _ = seed_xyz.shape
    mask = ops.take_rows(d["vote_label_mask"].float(), d["seed_inds"])
    gt = ops.take_rows(d["vote_label"], d["seed_inds"]) + seed_xyz.repeat(1, 1, 3)
    _, _, dist2, _ = ops.nn_distance(vote_xyz.reshape(B * S, 1, 3),
                                     gt.reshape(B * S, 3, 3), l1=True)
    dist = torch.amin(dist2, dim=1).reshape(B, S)
    return torch.sum(dist * mask) / (torch.sum(mask) + 1e-6)


def objectness(d):
    """(loss, label, mask, assignment) of each proposal by its nearest GT
    centre."""
    dist1, ind1, _, _ = ops.nn_distance(d["aggregated_vote_xyz"],
                                        d["center_label"][:, :, 0:3])
    euclid = torch.sqrt(dist1.detach() + 1e-6)
    label = (euclid < NEAR).long()
    mask = ((euclid < NEAR) | (euclid > FAR)).float()
    scores = d["objectness_scores"]
    w = scores.new_tensor(OBJECTNESS_WEIGHTS)[label]
    ce = ops.ce_logits(scores, label) * w
    return (torch.sum(ce * mask) / (torch.sum(mask) + 1e-6), label, mask,
            ind1)


def box_and_sem(d, label, assignment):
    obj = label.float()
    denom = torch.sum(obj) + 1e-6
    gt_center = d["center_label"][:, :, 0:3]
    dist1, _, dist2, _ = ops.nn_distance(d["center"], gt_center)
    box_mask = d["box_label_mask"].float()
    center = (torch.sum(dist1 * obj) / denom
              + torch.sum(dist2 * box_mask) / (torch.sum(box_mask) + 1e-6))
    hcls = ops.take_rows(d["heading_class_label"], assignment)
    heading_cls = torch.sum(ops.ce_logits(d["heading_scores"], hcls)
                            * obj) / denom
    hres = ops.take_rows(d["heading_residual_label"].float(), assignment)
    hres = hres / (torch.pi / 1)
    onehot = torch.nn.functional.one_hot(hcls.long(), 1).float()
    pred_h = torch.sum(d["heading_residuals_normalized"] * onehot, dim=-1)
    heading_reg = torch.sum(ops.huber_loss(pred_h - hres) * obj) / denom
    scls = ops.take_rows(d["size_class_label"], assignment)
    size_cls = torch.sum(ops.ce_logits(d["size_scores"], scls) * obj) / denom
    sres = ops.take_rows(d["size_residual_label"], assignment)
    onehot = torch.nn.functional.one_hot(scls.long(), 18).float()
    pred_s = torch.sum(d["size_residuals_normalized"] * onehot[..., None],
                       dim=2)
    mean = pred_s.new_tensor(ops.MEAN_SIZE)[scls.long()]
    size_reg = torch.sum(torch.mean(ops.huber_loss(pred_s - sres / mean),
                                    dim=-1) * obj) / denom
    sem = ops.take_rows(d["sem_cls_label"], assignment)
    sem_cls = torch.sum(ops.ce_logits(d["sem_cls_scores"], sem) * obj) / denom
    box = center + 0.1 * heading_cls + heading_reg + 0.1 * size_cls + size_reg
    return box, sem_cls


def caption_loss(d):
    logits = d["lang_cap"]
    T = logits.shape[1]
    targets = d["lang_ids"][:, 1:T + 1].long()
    steps = torch.arange(T, device=logits.device)[None, :]
    step_mask = (steps < (torch.max(d["lang_len"]) - 1)).float()
    pad = (targets != 0).float()
    good = d["good_bbox_masks"].float()[:, None]
    ce = ops.ce_logits(logits, targets) * pad
    return torch.sum(ce * good * step_mask) / (torch.sum(good * step_mask)
                                               + 1e-6)


def orientation_loss(d, assignment, num_bins):
    nbr, edge_mask = d["edge_nbr_idx"], d["edge_mask"]
    B, K, L = nbr.shape
    assignment = assignment.long()
    tgt_obj = torch.gather(assignment, 1, nbr.reshape(B, K * L).long()
                           ).reshape(B, K, L)
    rows = torch.arange(B, device=nbr.device)[:, None]

    def take(x, obj_idx):
        return x[rows, obj_idx.reshape(B, -1)].reshape(obj_idx.shape
                                                       + x.shape[2:])

    rot = d["scene_object_rotations"]
    rot_mask = d["scene_object_rotation_masks"].float()
    src_rot, tgt_rot = take(rot, assignment[..., None]), take(rot, tgt_obj)
    src_m, tgt_m = take(rot_mask, assignment[..., None]), take(rot_mask, tgt_obj)
    rel = ops.einsum("bklij,bklmj->bklim", src_rot.expand_as(tgt_rot),
                     tgt_rot)
    trace = rel[..., 0, 0] + rel[..., 1, 1] + rel[..., 2, 2]
    angle = torch.arccos(torch.clamp(0.5 * (trace - 1.0), -1.0, 1.0))
    labels = ops.rotation_angle_labels(angle, num_bins)
    masks = src_m.expand_as(tgt_m) * tgt_m * edge_mask
    ce = ops.ce_logits(d["edge_orientations"], labels)
    return torch.sum(ce * masks) / (torch.sum(masks) + 1e-8)


def capnet_loss(d, num_bins):
    """10 * (vote + 0.5 objectness + box + 0.1 sem_cls) + caption
    + 0.1 orientation."""
    votes = vote_loss(d)
    obj, label, _, assignment = objectness(d)
    box, sem = box_and_sem(d, label, assignment)
    loss = (votes + 0.5 * obj + box + 0.1 * sem) * 10.0
    loss = loss + caption_loss(d)
    return loss + 0.1 * orientation_loss(d, assignment, num_bins)


def mask_votenet_loss(d):
    """10 * (vote + box + 0.1 sem_cls), box = centre + 0.1 size_cls +
    size_reg, each a mean over the one proposal of every sample."""
    votes = vote_loss(d)
    dist1, _, _, _ = ops.nn_distance(d["center"], d["center_label"][:, :, 0:3])
    center = torch.sqrt(dist1 + 1e-8)
    center = torch.sum(center) / center.numel()
    scls = d["size_class_label"].long()
    size_cls = ops.ce_logits(d["size_scores"], scls)
    size_cls = torch.sum(size_cls) / size_cls.numel()
    onehot = torch.nn.functional.one_hot(scls, 18).float()
    pred = torch.sum(d["size_residuals_normalized"] * onehot[..., None], dim=2)
    mean = pred.new_tensor(ops.MEAN_SIZE)[scls]
    reg = ops.huber_loss(pred - d["size_residual_label"] / mean)
    size_reg = torch.sum(reg) / reg.numel()
    sem = ops.ce_logits(d["sem_cls_scores"], d["sem_cls_label"].long())
    sem = torch.sum(sem) / sem.numel()
    box = center + 0.1 * size_cls + size_reg
    zero = torch.zeros((), device=center.device)
    return (votes + 0.5 * zero + box + 0.1 * sem) * 10.0
