"""MaskVoteNet dataset (copy of ``scan2cap_tpu/data/dataset_maskvotenet.py``;
reference lib/dataset_maskvotenet.py).

One (scene, object) pair per sample (deduplicated, :507-520).  Biased
sampling: at least 1,024 points drawn from the target object (with
replacement if it has fewer) and the rest from the whole scene (:522-553).
A binary target-mask channel is appended after augmentation (:476-478);
every point votes to the target's AABB centre (:483-489); the labels
describe the single target box.

The sample is assembled in numpy, as the JAX package's subclass does: the
same ``RandomState`` numbers drawn in the same order give the JAX item, key
for key.  The base class's scenes, vocabulary and multiview reader are
shared.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence

import numpy as np

from scan2cap_torch.config import MEAN_COLOR_RGB, SCANNET_MEAN_SIZE_ARR
from scan2cap_torch.data.dataset import (
    DC_NYU2CLS, ScannetReferenceDataset, _get_3d_box_batch_np,
    rotate_aligned_boxes_along_axis,
)
from scan2cap_torch.utils.pc_utils import rotx, roty, rotz

MIN_NUM_OBJ_PTS = 1024


def _filter_object(data: Sequence[dict]):
    """Deduplicate (scene, object) pairs (:507-520)."""
    seen, out = set(), []
    for d in data:
        key = (d["scene_id"], d["object_id"])
        if key not in seen:
            seen.add(key)
            out.append(d)
    return out


class MaskScannetReferenceDataset(ScannetReferenceDataset):
    def __init__(self, scanrefer, *args, **kwargs):
        super().__init__(_filter_object(scanrefer), *args, **kwargs)

    def _biased_sampling(self, point_cloud, object_id, instance_labels, rs):
        """At least MIN_NUM_OBJ_PTS on the target, the rest from the scene
        (:522-553)."""
        ind_mask = instance_labels == object_id
        n_obj = min(MIN_NUM_OBJ_PTS, self.num_points)
        obj_idx_pool = np.where(ind_mask)[0]
        if len(obj_idx_pool) == 0:
            raise ValueError(f"no point of the scene carries instance label "
                             f"{object_id}")
        replace = len(obj_idx_pool) < n_obj
        obj_choice = rs.choice(len(obj_idx_pool), n_obj, replace=replace)
        bg_choice = rs.choice(len(point_cloud), self.num_points - n_obj,
                              replace=len(point_cloud) < self.num_points - n_obj)
        choices = np.concatenate([obj_idx_pool[obj_choice], bg_choice])
        return point_cloud[choices], choices

    def __getitem__(self, idx: int,
                    rs: Optional[np.random.RandomState] = None) -> Dict:
        rng = rs if rs is not None else np.random.RandomState()
        start = time.time()
        entry = self.scanrefer[idx]
        scene_id = entry["scene_id"]
        object_id = int(entry["object_id"])

        scene = self.scene_data[scene_id]
        mesh_vertices = scene["mesh_vertices"]
        instance_labels = scene["instance_labels"]
        instance_bboxes = scene["instance_bboxes"]

        if not self.use_color:
            point_cloud = mesh_vertices[:, 0:3].copy()
        else:
            point_cloud = mesh_vertices[:, 0:6].copy()
            point_cloud[:, 3:6] = (point_cloud[:, 3:6] - MEAN_COLOR_RGB) / 256.0
        if self.use_normal:
            point_cloud = np.concatenate([point_cloud, mesh_vertices[:, 6:9]], 1)
        if self.use_multiview:
            mv = np.asarray(self._multiview(scene_id))
            point_cloud = np.concatenate([point_cloud, mv], 1)
        if self.use_height:
            floor = np.percentile(point_cloud[:, 2], 0.99)
            point_cloud = np.concatenate(
                [point_cloud, (point_cloud[:, 2] - floor)[:, None]], 1)

        # instance labels in the npys are 1-indexed; target is object_id + 1
        point_cloud, choices = self._biased_sampling(
            point_cloud, object_id + 1, instance_labels, rng)
        instance_labels = instance_labels[choices]

        target_bboxes = np.zeros((1, 6))
        size_classes = np.zeros((1,))
        size_residuals = np.zeros((1, 3))
        bbox_ind = int(np.where(instance_bboxes[:, -1] == object_id)[0][0])
        target_bboxes[0] = instance_bboxes[bbox_ind, 0:6]

        if self.augment:
            if rng.random_sample() > 0.5:
                point_cloud[:, 0] = -point_cloud[:, 0]
                target_bboxes[:, 0] = -target_bboxes[:, 0]
            if rng.random_sample() > 0.5:
                point_cloud[:, 1] = -point_cloud[:, 1]
                target_bboxes[:, 1] = -target_bboxes[:, 1]
            for rot_fn, axis in ((rotx, "x"), (roty, "y"), (rotz, "z")):
                angle = rng.random_sample() * np.pi / 18 - np.pi / 36
                rot = rot_fn(angle)
                point_cloud[:, 0:3] = point_cloud[:, 0:3] @ rot.T
                target_bboxes = rotate_aligned_boxes_along_axis(
                    target_bboxes, rot, axis)
            factor = rng.choice(np.arange(-0.5, 0.501, 0.001), size=3)
            point_cloud[:, 0:3] += factor
            target_bboxes[:, 0:3] += factor

        # the target-mask channel (:476-478)
        target_mask = (instance_labels == object_id + 1).astype(np.float32)
        point_cloud = np.concatenate([point_cloud, target_mask[:, None]], 1)

        # every point votes to the target's centre (:483-489)
        x = point_cloud[target_mask == 1, :3]
        center = 0.5 * (x.min(0) + x.max(0))
        point_votes = np.tile(center - point_cloud[:, :3], (1, 3))
        point_votes_mask = np.ones(self.num_points)

        cls_ind = DC_NYU2CLS[int(instance_bboxes[bbox_ind, -2])]
        size_classes[0] = cls_ind
        size_residuals[0] = target_bboxes[0, 3:6] - SCANNET_MEAN_SIZE_ARR[cls_ind]

        bbox_corner = _get_3d_box_batch_np(
            target_bboxes[:, 3:6], np.zeros(1), target_bboxes[:, 0:3])[0]

        return {
            "point_clouds": point_cloud.astype(np.float32),
            "center_label": target_bboxes[:, 0:3].astype(np.float32),
            "heading_class_label": np.zeros((1,), np.int32),
            "heading_residual_label": np.zeros((1,), np.float32),
            "size_class_label": size_classes.astype(np.int32),
            "size_residual_label": size_residuals.astype(np.float32),
            "sem_cls_label": np.array([cls_ind], np.int32),
            "box_label_mask": np.ones((1,), np.float32),
            "vote_label": point_votes.astype(np.float32),
            "vote_label_mask": point_votes_mask.astype(np.int32),
            "bbox_corner_label": bbox_corner.astype(np.float32),
            "dataset_idx": np.int32(idx),
            "object_id": np.int32(object_id),
            "scene_object_ids": np.array([object_id], np.int32),
            "load_time": np.float32(time.time() - start),
        }
