"""Object-centric dataset (copy of ``scan2cap_tpu/data/dataset_object.py``;
reference lib/dataset.py:619-997, ScannetObjectDataset).

One (scene, object) per sample (deduplicated unless captioning).  The
points are the whole scene sampled to ``num_points`` with a binary
target-instance mask channel appended (lib/dataset.py:940-952,
_get_object_pc); the labels are the object's category and caption.
``whole_scene`` mode gives one masked crop per labelled object of the
scene, padded to ``max_num_obj``, for ``PointnetEncoder(whole_scene=True)``.
The same ``RandomState`` numbers drawn in the same order give the JAX item,
key for key.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np

from scan2cap_torch.config import MEAN_COLOR_RGB
from scan2cap_torch.data.dataset import (DC_NYU2CLS, ScannetReferenceDataset,
                                         _get_3d_box_batch_np)
from scan2cap_torch.data.dataset_maskvotenet import _filter_object
from scan2cap_torch.data.vocab import encode_caption
from scan2cap_torch.utils.pc_utils import random_sampling, rotx, roty, rotz


def _filter_scene(data):
    seen, out = set(), []
    for d in data:
        if d["scene_id"] not in seen:
            seen.add(d["scene_id"])
            out.append(d)
    return out


class ScannetObjectDataset(ScannetReferenceDataset):
    def __init__(self, scanrefer, *args, num_points: int = 1024,
                 is_caption: bool = False, is_eval: bool = False,
                 whole_scene: bool = False, **kwargs):
        entries = scanrefer if is_caption else _filter_object(scanrefer)
        if is_eval and whole_scene:
            entries = _filter_scene(entries)
        super().__init__(entries, *args, num_points=num_points, **kwargs)
        self.is_caption = is_caption
        self.is_eval = is_eval
        self.whole_scene = whole_scene

    def _assemble_features(self, scene_id, rng):
        scene = self.scene_data[scene_id]
        mesh_vertices = scene["mesh_vertices"]
        if not self.use_color:
            pc = mesh_vertices[:, 0:3].copy()
        else:
            pc = mesh_vertices[:, 0:6].copy()
            pc[:, 3:6] = (pc[:, 3:6] - MEAN_COLOR_RGB) / 256.0
        if self.use_normal:
            pc = np.concatenate([pc, mesh_vertices[:, 6:9]], 1)
        if self.use_multiview:
            pc = np.concatenate([pc, np.asarray(self._multiview(scene_id))], 1)
        if self.use_height:
            floor = np.percentile(pc[:, 2], 0.99)
            pc = np.concatenate([pc, (pc[:, 2] - floor)[:, None]], 1)
        if self.augment:
            if rng.random_sample() > 0.5:
                pc[:, 0] = -pc[:, 0]
            if rng.random_sample() > 0.5:
                pc[:, 1] = -pc[:, 1]
            for rot_fn in (rotx, roty, rotz):
                angle = rng.random_sample() * np.pi / 18 - np.pi / 36
                pc[:, 0:3] = pc[:, 0:3] @ rot_fn(angle).T
            pc[:, 0:3] += rng.choice(np.arange(-0.5, 0.501, 0.001), size=3)
        return pc

    def _object_pc(self, pc, instance_labels, object_id, rng):
        """A scene sample and the target's mask channel
        (lib/dataset.py:940-952)."""
        sampled, choices = random_sampling(pc, self.num_points,
                                           return_choices=True, rs=rng)
        mask = (instance_labels[choices] == object_id + 1).astype(np.float32)
        return np.concatenate([sampled, mask[:, None]], axis=1)

    def __getitem__(self, idx: int,
                    rs: Optional[np.random.RandomState] = None) -> Dict:
        rng = rs if rs is not None else np.random.RandomState()
        start = time.time()
        entry = self.scanrefer[idx]
        scene_id = entry["scene_id"]
        object_id = int(entry["object_id"])
        scene = self.scene_data[scene_id]
        instance_labels = scene["instance_labels"]
        instance_bboxes = scene["instance_bboxes"]

        lang_feat, lang_ids, lang_len = encode_caption(
            entry["token"], self.vocabulary, self.glove, self.max_des_len)

        pc = self._assemble_features(scene_id, rng)
        M = self.max_num_obj

        out = {
            "lang_feat": lang_feat.astype(np.float32),
            "lang_ids": lang_ids.astype(np.int32),
            "lang_len": np.int32(min(lang_len, self.max_des_len + 2)),
            "dataset_idx": np.int32(idx),
            "object_id": np.int32(object_id),
            "load_time": np.float32(time.time() - start),
        }

        if self.whole_scene:
            num_bbox = min(len(instance_bboxes), M)
            crops = np.zeros((M, self.num_points, pc.shape[-1] + 1),
                             np.float32)
            cats = np.zeros((M,), np.int32)
            masks = np.zeros((M,), np.int32)
            ids = np.zeros((M,), np.int32)
            corners = np.zeros((M, 8, 3), np.float32)
            for i in range(num_bbox):
                oid = int(instance_bboxes[i, -1])
                crops[i] = self._object_pc(pc, instance_labels, oid, rng)
                cats[i] = DC_NYU2CLS[int(instance_bboxes[i, -2])]
                masks[i] = 1
                ids[i] = oid
                c, s = instance_bboxes[i, :3], instance_bboxes[i, 3:6]
                corners[i] = _get_3d_box_batch_np(
                    s[None], np.zeros(1), c[None])[0]
            out.update({
                "point_clouds": crops,
                "object_cat": cats,
                "target_masks": masks,
                "scene_object_ids": ids,
                "object_bbox_corners": corners,
            })
        else:
            bbox_ind = np.where(instance_bboxes[:, -1] == object_id)[0]
            cat = (DC_NYU2CLS[int(instance_bboxes[int(bbox_ind[0]), -2])]
                   if len(bbox_ind) else 17)
            out.update({
                "point_clouds": self._object_pc(
                    pc, instance_labels, object_id, rng).astype(np.float32),
                "object_cat": np.int32(cat),
            })
        return out
