"""Pretrained-feature datasets (copy of
``scan2cap_tpu/data/dataset_pretrained.py``; reference
lib/dataset_pretrained.py), over the port's feature store.

Caption (and graph) training over stored box features:

* ``PretrainedGTDataset``: features that MaskVoteNet extracted for every
  GT box, stored per augmentation epoch under
  ``"{epoch}|{scene_id}_gt_ids" / "_features" / "_gt_corners"``
  (lib/dataset_pretrained.py:725-755); in training a random stored epoch
  (of NUM_PRESET_EPOCHS=100, :32, capped to what the database holds) is
  drawn per sample; K = 128 padded boxes; the caption's target is
  ``bbox_idx`` (the oracle).

* ``PretrainedVoteNetDataset``: stored VoteNet proposals
  (``"0|{scene_id}_object_ids / _features / _bbox_corners / _gt_ids /
  _gt_corners"``, :956-1037); K = 256; near-one-hot objectness (the
  reference's fill(1e-8) construction, :861-862).

The database is the port's ``.npz`` store or an HDF5 file
(``data/feature_store.py``), opened once per dataset by the first Loader
thread that reads.  One seed gives the JAX package's item, key for key.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np

from scan2cap_torch.data.feature_store import LazyStore, open_feature_store
from scan2cap_torch.data.vocab import (build_embedding_table,
                                       build_vocabulary, encode_caption)

NUM_PRESET_EPOCHS = 100
FEAT_SIZE = 128


class _PretrainedBase:
    """Caption and vocabulary machinery without the scenes' points."""

    def __init__(self, scanrefer, features_path: str, split: str, glove,
                 vocab, max_des_len: int, scan2cad_rotation,
                 max_num_obj: int):
        self.scanrefer = list(scanrefer)
        self.glove = glove
        self.vocabulary = vocab if vocab is not None else build_vocabulary(
            self.scanrefer, glove, max_des_len)
        self.num_vocabs = len(self.vocabulary["word2idx"])
        self.emb_table = build_embedding_table(self.vocabulary, self.glove)
        self.max_des_len = max_des_len
        self.max_num_obj = max_num_obj
        self.scan2cad_rotation = scan2cad_rotation
        self.weights = np.ones((self.num_vocabs,), np.float64)
        self.features_path = features_path
        self.split = split
        self._db = LazyStore(features_path)

    def __len__(self):
        return len(self.scanrefer)

    def _lang(self, entry):
        return encode_caption(entry["token"], self.vocabulary, self.glove,
                              self.max_des_len)

    def _rotations(self, scene_id, object_ids):
        M = len(object_ids)
        rot = np.zeros((M, 3, 3), np.float32)
        mask = np.zeros((M,), np.int32)
        if self.scan2cad_rotation and scene_id in self.scan2cad_rotation:
            for i, oid in enumerate(np.asarray(object_ids).astype(int)):
                r = self.scan2cad_rotation[scene_id].get(str(oid))
                if r is not None:
                    rot[i] = np.asarray(r)
                    mask[i] = 1
        return rot, mask

    def _common(self, idx, entry, start):
        lang_feat, lang_ids, lang_len = self._lang(entry)
        return {
            "lang_feat": lang_feat.astype(np.float32),
            "lang_len": np.int32(min(lang_len, self.max_des_len + 2)),
            "lang_ids": lang_ids.astype(np.int32),
            "dataset_idx": np.int32(idx),
            "object_id": np.int32(int(entry["object_id"])),
            "ann_id": np.int32(int(entry.get("ann_id", 0))),
            "load_time": np.float32(time.time() - start),
        }


class PretrainedGTDataset(_PretrainedBase):
    def __init__(self, scanrefer, features_path: str, split: str = "train",
                 glove=None, vocab=None, max_des_len: int = 30,
                 scan2cad_rotation=None,
                 num_preset_epochs: int = NUM_PRESET_EPOCHS, K: int = 128):
        super().__init__(scanrefer, features_path, split, glove, vocab,
                         max_des_len, scan2cad_rotation, K)
        self.K = K
        # cap the stored-epoch draw to what the database holds (an
        # extraction may have run fewer --epoch passes than 100).  Done
        # here, with a handle of its own: the Loader's threads must never
        # see the uncapped value and draw a missing epoch
        self.num_preset_epochs = num_preset_epochs
        if split == "train":
            try:
                with open_feature_store(features_path) as db:
                    avail = {int(k.split("|", 1)[0]) for k in db.keys()
                             if "|" in k}
            except FileNotFoundError:
                avail = set()           # a missing file fails later, loudly
            if avail:
                self.num_preset_epochs = min(num_preset_epochs,
                                             max(avail) + 1)

    def __getitem__(self, idx: int,
                    rs: Optional[np.random.RandomState] = None) -> Dict:
        rng = rs if rs is not None else np.random.RandomState()
        start = time.time()
        entry = self.scanrefer[idx]
        scene_id = entry["scene_id"]
        object_id = int(entry["object_id"])
        db = self._db.get()

        epoch = (rng.randint(self.num_preset_epochs)
                 if self.split == "train" else 0)
        prefix = f"{epoch}|{scene_id}"
        gt_ids = db[prefix + "_gt_ids"]                   # (M,)
        feats = db[prefix + "_features"]                  # (M, 128)
        corners = db[prefix + "_gt_corners"]              # (M, 8, 3)
        M = len(gt_ids)

        K = self.K
        bbox_feature = np.zeros((K, FEAT_SIZE), np.float32)
        bbox_corner = np.zeros((K, 8, 3), np.float32)
        bbox_mask = np.zeros((K,), np.int32)
        object_ids = np.zeros((K,), np.int32)
        n = min(M, K)
        bbox_feature[:n] = feats[:n]
        bbox_corner[:n] = corners[:n]
        bbox_mask[:n] = 1
        object_ids[:n] = gt_ids[:n]

        where = np.where(gt_ids[:n] == object_id)[0]
        bbox_idx = int(where[0]) if len(where) else 0

        # rotations for the n real slots only: padded ids are 0, and object
        # 0 is usually in the Scan2CAD map, so the pads would be supervised
        # with object 0's rotation (the reference iterates the unpadded
        # ids, lib/dataset_pretrained.py:631)
        rot = np.zeros((K, 3, 3), np.float32)
        rot_mask = np.zeros((K,), np.int32)
        rot[:n], rot_mask[:n] = self._rotations(scene_id, object_ids[:n])

        return {
            "bbox_feature": bbox_feature,
            "bbox_corner": bbox_corner,
            "bbox_mask": bbox_mask,
            "bbox_idx": np.int32(bbox_idx),
            "scene_object_ids": object_ids,
            "scene_object_rotations": rot,
            "scene_object_rotation_masks": rot_mask,
            **self._common(idx, entry, start),
        }


class PretrainedVoteNetDataset(_PretrainedBase):
    def __init__(self, scanrefer, features_path: str, split: str = "train",
                 glove=None, vocab=None, max_des_len: int = 30,
                 scan2cad_rotation=None, K: int = 256, max_gt: int = 128):
        super().__init__(scanrefer, features_path, split, glove, vocab,
                         max_des_len, scan2cad_rotation, max_gt)
        self.K = K
        self.max_gt = max_gt

    def __getitem__(self, idx: int,
                    rs: Optional[np.random.RandomState] = None) -> Dict:
        start = time.time()
        entry = self.scanrefer[idx]
        scene_id = entry["scene_id"]
        object_id = int(entry["object_id"])
        db = self._db.get()

        prefix = f"0|{scene_id}"
        object_ids = db[prefix + "_object_ids"]               # (P,)
        feats = db[prefix + "_features"]                      # (P, 128)
        corners = db[prefix + "_bbox_corners"]                # (P, 8, 3)
        gt_ids = db[prefix + "_gt_ids"]                       # (M,)
        gt_corners = db[prefix + "_gt_corners"]               # (M, 8, 3)

        K = self.K
        P = min(len(object_ids), K)
        bbox_feature = np.zeros((K, FEAT_SIZE), np.float32)
        bbox_corner = np.zeros((K, 8, 3), np.float32)
        bbox_mask = np.zeros((K,), np.int32)
        prop_object_ids = np.zeros((K,), np.int32)
        bbox_feature[:P] = feats[:P]
        bbox_corner[:P] = corners[:P]
        bbox_mask[:P] = 1
        prop_object_ids[:P] = object_ids[:P]

        # near-one-hot objectness, the reference's fill construction
        # (lib/dataset_pretrained.py:861-862): pads [1e-8, 1e-8], real
        # slots [1e-8, 1 - 1e-8]
        objectness = np.full((K, 2), 1e-8, np.float32)
        objectness[:P, 1] = 1.0 - 1e-8

        # the reference box: the GT box of the described object
        ref_box_corner_label = np.zeros((8, 3), np.float32)
        where = np.where(gt_ids == object_id)[0]
        if len(where):
            ref_box_corner_label = gt_corners[where[0]].astype(np.float32)

        Mg = min(len(gt_ids), self.max_gt)
        gt_box_corner = np.zeros((self.max_gt, 8, 3), np.float32)
        gt_box_masks = np.zeros((self.max_gt,), np.int32)
        gt_box_ids = np.zeros((self.max_gt,), np.int32)
        gt_box_corner[:Mg] = gt_corners[:Mg]
        gt_box_masks[:Mg] = 1
        gt_box_ids[:Mg] = gt_ids[:Mg]

        # the same real-slot gating as the GT dataset
        rot = np.zeros((K, 3, 3), np.float32)
        rot_mask = np.zeros((K,), np.int32)
        rot[:P], rot_mask[:P] = self._rotations(scene_id, prop_object_ids[:P])

        return {
            "bbox_feature": bbox_feature,
            "bbox_corner": bbox_corner,
            "bbox_mask": bbox_mask,
            "objectness_scores": objectness,
            "scene_object_ids": prop_object_ids,
            "scene_object_rotations": rot,
            "scene_object_rotation_masks": rot_mask,
            "ref_box_corner_label": ref_box_corner_label,
            "gt_box_corner_label": gt_box_corner,
            "gt_box_masks": gt_box_masks,
            "gt_box_object_ids": gt_box_ids,
            **self._common(idx, entry, start),
        }
