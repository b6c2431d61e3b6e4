"""Synthetic ScanRefer-style scenes (numpy-only copy of
``scan2cap_tpu/data/synthetic.py:20-170``).

``make_vocab`` and ``make_scene_batch`` draw the same numbers from the same
seed as the JAX package's functions, so both packages see one batch, with
the keys and shapes of the reference dataset output (lib/dataset.py:503-540):
the point cloud, vote labels (tiled x3), box labels padded to
``max_num_obj``, GT corner boxes, the reference box, and a random-token
caption with its embedding (whose first row is the sos embedding).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from scan2cap_torch.config import ModelConfig, SCANNET_MEAN_SIZE_ARR
from scan2cap_torch.device import resolve_device


def make_vocab(num_vocabs: int = 64, emb_size: int = 300,
               seed: int = 0) -> Dict:
    """Toy vocabulary: the reference's 4 special tokens at ids 0-3
    (lib/dataset.py:182) and a random embedding table."""
    rs = np.random.RandomState(seed)
    words = ["pad_", "unk", "sos", "eos"] + [
        f"word{i}" for i in range(num_vocabs - 4)]
    table = rs.randn(num_vocabs, emb_size).astype(np.float32) * 0.1
    table[0] = 0.0  # pad embedding
    return {
        "word2idx": {w: i for i, w in enumerate(words)},
        "idx2word": {str(i): w for i, w in enumerate(words)},
        "emb_table": table,
    }


def make_scene_batch(
    cfg: ModelConfig,
    batch_size: int = 2,
    num_objects: int = 4,
    vocab: Optional[Dict] = None,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """Random rooms with a few axis-aligned boxes: every key of
    ``scan2cap_tpu.data.synthetic.make_scene_batch`` with equal values for
    equal seeds (point cloud, votes, padded box labels, GT corners, the
    reference box, a random-token caption and the embedding table)."""
    rs = np.random.RandomState(seed)
    if vocab is None:
        vocab = make_vocab(emb_size=cfg.emb_size)
    V = len(vocab["word2idx"])
    N = cfg.num_points
    M = cfg.max_num_obj
    T = cfg.max_des_len + 2
    in_dim = cfg.input_feature_dim

    pc = np.zeros((batch_size, N, 3 + in_dim), np.float32)
    vote_label = np.zeros((batch_size, N, 9), np.float32)
    vote_label_mask = np.zeros((batch_size, N), np.int32)
    center_label = np.zeros((batch_size, M, 3), np.float32)
    box_label_mask = np.zeros((batch_size, M), np.float32)
    heading_class_label = np.zeros((batch_size, M), np.int32)
    heading_residual_label = np.zeros((batch_size, M), np.float32)
    size_class_label = np.zeros((batch_size, M), np.int32)
    size_residual_label = np.zeros((batch_size, M, 3), np.float32)
    sem_cls_label = np.zeros((batch_size, M), np.int32)
    gt_box_corner_label = np.zeros((batch_size, M, 8, 3), np.float32)
    gt_box_masks = np.zeros((batch_size, M), np.int32)
    gt_box_object_ids = np.zeros((batch_size, M), np.int32)
    scene_object_ids = np.zeros((batch_size, M), np.int32)
    rotations = np.zeros((batch_size, M, 3, 3), np.float32)
    rotation_masks = np.zeros((batch_size, M), np.int32)
    ref_box_corner_label = np.zeros((batch_size, 8, 3), np.float32)
    ref_center_label = np.zeros((batch_size, 3), np.float32)
    ref_size_class_label = np.zeros((batch_size,), np.int32)
    ref_size_residual_label = np.zeros((batch_size, 3), np.float32)
    lang_feat = np.zeros((batch_size, T, cfg.emb_size), np.float32)
    lang_ids = np.zeros((batch_size, T), np.int32)
    lang_len = np.zeros((batch_size,), np.int32)
    object_ids = np.zeros((batch_size,), np.int32)

    table = vocab["emb_table"]
    sos_id = vocab["word2idx"]["sos"]
    eos_id = vocab["word2idx"]["eos"]

    for b in range(batch_size):
        # room-scale background points
        pc[b, :, 0:2] = rs.uniform(-4, 4, (N, 2))
        pc[b, :, 2] = rs.uniform(0, 0.05, N)

        pts_per_obj = N // (2 * num_objects)
        cursor = 0
        for o in range(num_objects):
            cls = rs.randint(0, cfg.num_class)
            size = SCANNET_MEAN_SIZE_ARR[cls] * rs.uniform(0.8, 1.2, 3)
            center = np.array([
                rs.uniform(-3, 3), rs.uniform(-3, 3), size[2] / 2 + 0.05])
            lo, hi = center - size / 2, center + size / 2
            pts = rs.uniform(lo, hi, (pts_per_obj, 3)).astype(np.float32)
            pc[b, cursor:cursor + pts_per_obj, :3] = pts
            # votes: every in-box point votes to the box center of its points
            pcenter = 0.5 * (pts.min(0) + pts.max(0))
            vote = (pcenter - pts).astype(np.float32)
            vote_label[b, cursor:cursor + pts_per_obj] = np.tile(vote, (1, 3))
            vote_label_mask[b, cursor:cursor + pts_per_obj] = 1
            cursor += pts_per_obj

            center_label[b, o] = center
            box_label_mask[b, o] = 1
            size_class_label[b, o] = cls
            size_residual_label[b, o] = size - SCANNET_MEAN_SIZE_ARR[cls]
            sem_cls_label[b, o] = cls
            gt_box_masks[b, o] = 1
            gt_box_object_ids[b, o] = o
            scene_object_ids[b, o] = o
            # corner order matches get_3d_box (heading 0)
            sx = np.array([1, 1, -1, -1, 1, 1, -1, -1]) * size[0] / 2
            sy = np.array([1, -1, -1, 1, 1, -1, -1, 1]) * size[1] / 2
            sz = np.array([1, 1, 1, 1, -1, -1, -1, -1]) * size[2] / 2
            gt_box_corner_label[b, o] = np.stack([sx, sy, sz], 1) + center
            theta = rs.uniform(0, np.pi)
            c, s = np.cos(theta), np.sin(theta)
            rotations[b, o] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
            rotation_masks[b, o] = 1

        # reference target = object 0
        ref = rs.randint(0, num_objects)
        object_ids[b] = ref
        ref_box_corner_label[b] = gt_box_corner_label[b, ref]
        ref_center_label[b] = center_label[b, ref]
        ref_size_class_label[b] = size_class_label[b, ref]
        ref_size_residual_label[b] = size_residual_label[b, ref]

        # caption: sos w1..wk eos pad...
        k = rs.randint(3, cfg.max_des_len)
        ids = [sos_id] + list(rs.randint(4, V, k)) + [eos_id]
        lang_ids[b, :len(ids)] = ids
        lang_len[b] = len(ids)
        lang_feat[b, :len(ids)] = table[ids]

        if cfg.use_height:
            floor = np.percentile(pc[b, :, 2], 0.99)
            pc[b, :, 3 + 3 * cfg.use_color + 3 * cfg.use_normal
               + 128 * cfg.use_multiview] = pc[b, :, 2] - floor

    return {
        "point_clouds": pc,
        "lang_feat": lang_feat,
        "lang_len": lang_len,
        "lang_ids": lang_ids,
        "center_label": center_label,
        "heading_class_label": heading_class_label,
        "heading_residual_label": heading_residual_label,
        "size_class_label": size_class_label,
        "size_residual_label": size_residual_label,
        "sem_cls_label": sem_cls_label,
        "box_label_mask": box_label_mask,
        "vote_label": vote_label,
        "vote_label_mask": vote_label_mask,
        "scene_object_ids": scene_object_ids,
        "scene_object_rotations": rotations,
        "scene_object_rotation_masks": rotation_masks,
        "gt_box_corner_label": gt_box_corner_label,
        "gt_box_masks": gt_box_masks,
        "gt_box_object_ids": gt_box_object_ids,
        "ref_box_corner_label": ref_box_corner_label,
        "ref_center_label": ref_center_label,
        "ref_size_class_label": ref_size_class_label,
        "ref_size_residual_label": ref_size_residual_label,
        "object_id": object_ids,
        "glove_emb_table": table,
    }


def make_mask_votenet_batch(cfg: ModelConfig, batch_size: int = 2,
                            num_objects: int = 4,
                            seed: int = 0) -> Dict[str, np.ndarray]:
    """A MaskVoteNet batch with the keys of the port's mask dataset
    (``data/dataset_maskvotenet.py``): the rooms of ``make_scene_batch``,
    the mask of each scene's reference object appended as the last
    channel, every point voting to the centre of that object's points, and
    the labels of its one box."""
    scene = make_scene_batch(dataclasses.replace(cfg, max_num_obj=num_objects),
                             batch_size, num_objects, seed=seed)
    N = cfg.num_points
    per_obj = N // (2 * num_objects)             # make_scene_batch's layout
    pc = scene["point_clouds"]
    ref = scene["object_id"].astype(np.int64)
    rows = np.arange(batch_size)
    mask = np.zeros((batch_size, N, 1), np.float32)
    vote_label = np.zeros((batch_size, N, 9), np.float32)
    for b in range(batch_size):
        mask[b, ref[b] * per_obj:(ref[b] + 1) * per_obj] = 1.0
        pts = pc[b, mask[b, :, 0] == 1, :3]
        center = 0.5 * (pts.min(0) + pts.max(0))
        vote_label[b] = np.tile(center - pc[b, :, :3], (1, 3))
    return {
        "point_clouds": np.concatenate([pc, mask], -1),
        "center_label": scene["center_label"][rows, ref][:, None],
        "heading_class_label": np.zeros((batch_size, 1), np.int32),
        "heading_residual_label": np.zeros((batch_size, 1), np.float32),
        "size_class_label": scene["size_class_label"][rows, ref][:, None],
        "size_residual_label": scene["size_residual_label"][rows, ref][:, None],
        "sem_cls_label": scene["sem_cls_label"][rows, ref][:, None],
        "box_label_mask": np.ones((batch_size, 1), np.float32),
        "vote_label": vote_label,
        "vote_label_mask": np.ones((batch_size, N), np.int32),
        "bbox_corner_label": scene["ref_box_corner_label"],
    }


def make_pretrained_batch(cfg: ModelConfig, mode: str = "gt",
                          batch_size: int = 2, vocab: Optional[Dict] = None,
                          num_boxes: Optional[int] = None, max_gt: int = 128,
                          seed: int = 0) -> Dict[str, np.ndarray]:
    """A batch of the pretrained datasets' keys
    (``data/dataset_pretrained.py``): ``cfg.num_proposals`` stored boxes a
    sample, the first ``num_boxes`` real (three quarters by default) with
    seeded features and axis-aligned corners in a room, the rest padding;
    Scan2CAD-style rotations about z on half of the real boxes, the boxes'
    centres, a random-token caption and a reference box that overlaps the
    target box (which the plain caption head selects by, in both modes).
    "gt" mode adds the oracle target ``bbox_idx``; "votenet" mode the
    near-one-hot objectness and the GT boxes."""
    rs = np.random.RandomState(seed)
    if vocab is None:
        vocab = make_vocab(emb_size=cfg.emb_size)
    V = len(vocab["word2idx"])
    B, K, T = batch_size, cfg.num_proposals, cfg.max_des_len + 2
    n = num_boxes if num_boxes is not None else 3 * K // 4
    table = vocab["emb_table"]
    sos_id, eos_id = vocab["word2idx"]["sos"], vocab["word2idx"]["eos"]
    sx = np.array([1, 1, -1, -1, 1, 1, -1, -1], np.float32)
    sy = np.array([1, -1, -1, 1, 1, -1, -1, 1], np.float32)
    sz = np.array([1, 1, 1, 1, -1, -1, -1, -1], np.float32)

    feature = np.zeros((B, K, 128), np.float32)
    corner = np.zeros((B, K, 8, 3), np.float32)
    mask = np.zeros((B, K), np.int32)
    center = np.zeros((B, K, 3), np.float32)
    ids = np.zeros((B, K), np.int32)
    rot = np.zeros((B, K, 3, 3), np.float32)
    rot_mask = np.zeros((B, K), np.int32)
    target = np.zeros((B,), np.int32)
    lang_feat = np.zeros((B, T, cfg.emb_size), np.float32)
    lang_ids = np.zeros((B, T), np.int32)
    lang_len = np.zeros((B,), np.int32)
    for b in range(B):
        c = np.stack([rs.uniform(-4, 4, n), rs.uniform(-4, 4, n),
                      rs.uniform(0.2, 1.5, n)], 1).astype(np.float32)
        size = rs.uniform(0.3, 1.5, (n, 3)).astype(np.float32)
        center[b, :n] = c
        corner[b, :n] = np.stack([sx * size[:, :1] / 2, sy * size[:, 1:2] / 2,
                                  sz * size[:, 2:3] / 2], -1) + c[:, None]
        feature[b, :n] = rs.randn(n, 128).astype(np.float32) * 0.5
        mask[b, :n] = 1
        ids[b, :n] = np.arange(n)
        theta = rs.randint(0, 8, n) * np.pi / 8
        cos, sin = np.cos(theta), np.sin(theta)
        rot[b, :n, 0, 0], rot[b, :n, 0, 1] = cos, -sin
        rot[b, :n, 1, 0], rot[b, :n, 1, 1] = sin, cos
        rot[b, :n, 2, 2] = 1.0
        rot_mask[b, :n] = rs.rand(n) < 0.5
        target[b] = rs.randint(0, n)
        k = rs.randint(3, cfg.max_des_len)
        words = [sos_id] + list(rs.randint(4, V, k)) + [eos_id]
        lang_ids[b, :len(words)] = words
        lang_len[b] = len(words)
        lang_feat[b, :len(words)] = table[words]

    out = {
        "bbox_feature": feature,
        "bbox_corner": corner,
        "bbox_mask": mask,
        "scene_object_ids": ids,
        "scene_object_rotations": rot,
        "scene_object_rotation_masks": rot_mask,
        "center_label": center,
        "lang_feat": lang_feat,
        "lang_len": lang_len,
        "lang_ids": lang_ids,
        "object_id": target.copy(),
        "dataset_idx": np.arange(B, dtype=np.int32),
        "glove_emb_table": table,
    }
    # the reference box: the target's, shifted by up to a tenth of a metre
    rows = np.arange(B)
    shift = rs.uniform(-0.1, 0.1, (B, 1, 3)).astype(np.float32)
    out["ref_box_corner_label"] = corner[rows, target] + shift
    if mode == "gt":
        out["bbox_idx"] = target
    else:
        objectness = np.full((B, K, 2), 1e-8, np.float32)
        objectness[:, :n, 1] = 1.0 - 1e-8
        m = min(n, max_gt)
        gt = np.zeros((B, max_gt, 8, 3), np.float32)
        gt[:, :m] = corner[:, :m]
        gt_masks = np.zeros((B, max_gt), np.int32)
        gt_masks[:, :m] = 1
        gt_ids = np.zeros((B, max_gt), np.int32)
        gt_ids[:, :m] = np.arange(m)
        out.update(objectness_scores=objectness,
                   gt_box_corner_label=gt, gt_box_masks=gt_masks,
                   gt_box_object_ids=gt_ids)
    return out


def to_device(batch: Dict[str, np.ndarray],
              device: str | torch.device = "cuda") -> Dict[str, torch.Tensor]:
    """numpy batch -> tensors on ``device`` (CUDA unless asked otherwise).

    Always a copy, on the CPU too, where ``torch.as_tensor`` alone would
    alias the numpy memory: a ``Loader(reuse_buffers=True)`` batch is a
    ring slot that a worker overwrites two batches later.  The copy from
    pageable host memory has completed when this returns."""
    dev = resolve_device(device)
    return {k: torch.as_tensor(np.asarray(v)).to(dev, copy=True)
            for k, v in batch.items()}
