"""ScanRefer scene dataset → fixed-shape numpy batches
(copy of ``scan2cap_tpu/data/dataset.py``).

Host-side rebuild of lib/dataset.py (ScannetReferenceDataset).  Per-sample
pipeline order preserved exactly (lib/dataset.py:333-540):
  feature assembly (color normalized (rgb-MEAN)/256, normals, 128-d multiview
  from the feature store, height = z - 0.99-percentile floor) → random_sampling to
  num_points → augmentation (YZ/XZ flips p=0.5, ±5° rotations about x/y/z,
  ±0.5 m translation) → vote labels computed AFTER augmentation (per-instance
  AABB center offsets, tiled ×3) → padded box labels to MAX_NUM_OBJ →
  GT corner boxes → Scan2CAD rotation labels.

Differences from the reference (deliberate):
  * explicit np.random.RandomState threading (reproducible runs; the
    reference uses global np.random);
  * a thread-pool prefetching Loader replaces torch DataLoader workers;
  * every output is float32/int32 ready for device transfer.

One seed gives the JAX package's batch, key for key: the same per-sample
``RandomState`` threading and Loader seeds, and the same native data plane
(``scan2cap_torch/native``, a copy).
"""

from __future__ import annotations

from collections import deque
import json
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from scan2cap_torch import native
from scan2cap_torch.config import (
    MEAN_COLOR_RGB, SCANNET_MEAN_SIZE_ARR, SCANNET_NYU40IDS,
    SCANNET_TYPE2CLASS, param2obb_batch,
)
from scan2cap_torch.data.feature_store import LazyStore
from scan2cap_torch.data.vocab import (
    build_embedding_table, build_vocabulary, encode_caption, load_glove,
)
from scan2cap_torch.utils.pc_utils import rotx, roty, rotz


def _get_3d_box_batch_np(sizes, headings, centers):
    sx = np.array([1, 1, -1, -1, 1, 1, -1, -1])
    sy = np.array([1, -1, -1, 1, 1, -1, -1, 1])
    sz = np.array([1, 1, 1, 1, -1, -1, -1, -1])
    l, w, h = sizes[..., 0:1], sizes[..., 1:2], sizes[..., 2:3]
    corners = np.stack([l / 2 * sx, w / 2 * sy, h / 2 * sz], axis=-1)
    c, s = np.cos(headings), np.sin(headings)
    z = np.zeros_like(c)
    o = np.ones_like(c)
    R = np.stack([np.stack([c, z, s], -1), np.stack([z, o, z], -1),
                  np.stack([-s, z, c], -1)], -2)
    corners = np.einsum("...ij,...kj->...ki", R, corners)
    return corners + centers[..., None, :]


def rotate_aligned_boxes_along_axis(boxes: np.ndarray, rot_mat: np.ndarray,
                                    axis: str) -> np.ndarray:
    """Axis-aligned box re-fit under rotation
    (model_util_scannet.py:47-79, including its corner-slot quirk)."""
    centers, lengths = boxes[:, 0:3], boxes[:, 3:6]
    new_centers = centers @ rot_mat.T
    if axis == "x":
        d1, d2 = lengths[:, 1] / 2.0, lengths[:, 2] / 2.0
    elif axis == "y":
        d1, d2 = lengths[:, 0] / 2.0, lengths[:, 2] / 2.0
    else:
        d1, d2 = lengths[:, 0] / 2.0, lengths[:, 1] / 2.0
    new_1 = np.zeros((len(d1), 4))
    new_2 = np.zeros((len(d1), 4))
    for i, (sx, sy) in enumerate([(-1, -1), (1, -1), (1, 1), (-1, 1)]):
        crnrs = np.zeros((len(d1), 3))
        crnrs[:, 0] = sx * d1
        crnrs[:, 1] = sy * d2
        crnrs = crnrs @ rot_mat.T
        new_1[:, i] = crnrs[:, 0]
        new_2[:, i] = crnrs[:, 1]
    nd1 = 2.0 * new_1.max(1)
    nd2 = 2.0 * new_2.max(1)
    if axis == "x":
        new_lengths = np.stack((lengths[:, 0], nd1, nd2), axis=1)
    elif axis == "y":
        new_lengths = np.stack((nd1, lengths[:, 1], nd2), axis=1)
    else:
        new_lengths = np.stack((nd1, nd2, lengths[:, 2]), axis=1)
    return np.concatenate([new_centers, new_lengths], axis=1)


class ScannetReferenceDataset:
    """One (scene, object, annotation) sample per ScanRefer entry."""

    def __init__(
        self,
        scanrefer: Sequence[dict],
        scanrefer_all_scene: Sequence[str],
        scannet_data_dir: str,
        glove_path: str,
        split: str = "train",
        name: str = "ScanRefer",
        num_points: int = 40000,
        max_num_obj: int = 128,
        max_des_len: int = 30,
        use_height: bool = False,
        use_color: bool = False,
        use_normal: bool = False,
        use_multiview: bool = False,
        multiview_path: Optional[str] = None,
        augment: bool = False,
        scan2cad_rotation: Optional[dict] = None,
        vocab: Optional[dict] = None,
        glove: Optional[dict] = None,
    ):
        self.scanrefer = list(scanrefer)
        self.scanrefer_all_scene = list(scanrefer_all_scene)
        self.split = split
        self.name = name
        self.num_points = num_points
        self.max_num_obj = max_num_obj
        self.max_des_len = max_des_len
        self.use_height = use_height
        self.use_color = use_color
        self.use_normal = use_normal
        self.use_multiview = use_multiview
        self.multiview_path = multiview_path
        self.augment = augment
        self.scan2cad_rotation = scan2cad_rotation
        self.scannet_data_dir = scannet_data_dir

        self.glove = glove if glove is not None else load_glove(glove_path)
        self.vocabulary = vocab if vocab is not None else build_vocabulary(
            self.scanrefer, self.glove, max_des_len)
        self.num_vocabs = len(self.vocabulary["word2idx"])
        self.emb_table = build_embedding_table(self.vocabulary, self.glove)
        self.weights = np.ones((self.num_vocabs,), np.float64)

        self._load_scenes()
        self._multiview_db = LazyStore(multiview_path)
        self._mv_local = threading.local()

    # ------------------------------------------------------------------
    def _load_scenes(self):
        self.scene_list = sorted({d["scene_id"] for d in self.scanrefer})
        self.scene_data = {}
        for sid in self.scene_list:
            base = os.path.join(self.scannet_data_dir, sid)
            self.scene_data[sid] = {
                "mesh_vertices": np.load(base + "_aligned_vert.npy"),
                "instance_labels": np.load(base + "_ins_label.npy"),
                "semantic_labels": np.load(base + "_sem_label.npy"),
                "instance_bboxes": np.load(base + "_aligned_bbox.npy"),
            }

    def _multiview(self, scene_id: str) -> np.ndarray:
        # one store handle, opened by the first of the Loader's worker
        # threads under a lock (data/feature_store.py)
        db = self._multiview_db.get()
        # read into a reusable per-thread buffer: a fresh ~25 MB allocation
        # per sample is pure page-fault churn (the buffer's pages are hot
        # after the first scene)
        P, C = db.shape(scene_id)
        dtype = db.dtype(scene_id)
        buf = getattr(self._mv_local, "buf", None)
        if (buf is None or buf.shape[0] < P or buf.shape[1] != C
                or buf.dtype != dtype):
            buf = np.empty((max(P, 51200), C), dtype)
            self._mv_local.buf = buf
        return db.read_into(scene_id, buf[:P])

    def __len__(self):
        return len(self.scanrefer)

    # ------------------------------------------------------------------
    def __getitem__(self, idx: int,
                    rs: Optional[np.random.RandomState] = None) -> Dict:
        rng = rs if rs is not None else np.random.RandomState()
        start = time.time()
        entry = self.scanrefer[idx]
        scene_id = entry["scene_id"]
        object_id = int(entry["object_id"])
        object_name = " ".join(entry["object_name"].split("_"))
        ann_id = int(entry["ann_id"])

        lang_feat, lang_ids, lang_len = encode_caption(
            entry["token"], self.vocabulary, self.glove, self.max_des_len)

        scene = self.scene_data[scene_id]
        mesh_vertices = scene["mesh_vertices"]
        instance_labels = scene["instance_labels"]
        semantic_labels = scene["semantic_labels"]
        instance_bboxes = scene["instance_bboxes"]

        # ---- feature assembly (lib/dataset.py:338-363), sample-first ----
        # The reference concatenates the FULL-scene feature matrix (up to
        # 50000 x 135) and then row-samples it; assembling only the sampled
        # rows is bitwise identical (gather∘concat == concat∘gather, and the
        # height floor is still the full-scene z percentile) while skipping
        # ~50 MB of full-width intermediates per sample — the allocation
        # churn, not arithmetic, dominated this pipeline's CPU cost.
        P = mesh_vertices.shape[0]
        if self.use_height:
            floor = np.percentile(mesh_vertices[:, 2], 0.99)
        replace = P < self.num_points
        choices = rng.choice(P, self.num_points, replace=replace)

        # wide row gathers run in the native data plane
        # (scan2cap_torch/native, C++ with numpy fallbacks)
        verts = native.sample_gather(
            np.ascontiguousarray(
                mesh_vertices[:, :9 if self.use_normal else 6]), choices)
        parts = [verts[:, 0:3]]
        if self.use_color:
            parts.append((verts[:, 3:6] - MEAN_COLOR_RGB) / 256.0)
        if self.use_normal:
            parts.append(verts[:, 6:9])
        if self.use_multiview:
            mv = np.asarray(self._multiview(scene_id))
            parts.append(native.sample_gather(mv, choices))
        if self.use_height:
            parts.append((verts[:, 2] - floor)[:, None])
        point_cloud = (np.concatenate(parts, 1).astype(np.float32)
                       if len(parts) > 1 else parts[0].astype(np.float32))
        instance_labels = instance_labels[choices]
        semantic_labels = semantic_labels[choices]

        # ---- labels (lib/dataset.py:369-390) ----
        M = self.max_num_obj
        target_bboxes = np.zeros((M, 6))
        target_bboxes_mask = np.zeros((M,))
        angle_classes = np.zeros((M,))
        angle_residuals = np.zeros((M,))
        size_classes = np.zeros((M,))
        size_residuals = np.zeros((M, 3))
        ref_box_label = np.zeros(M)
        ref_center_label = np.zeros(3)
        ref_heading_class_label = 0
        ref_heading_residual_label = 0
        ref_size_class_label = 0
        ref_size_residual_label = np.zeros(3)
        ref_box_corner_label = np.zeros((8, 3))

        num_bbox = min(instance_bboxes.shape[0], M)
        target_bboxes_mask[:num_bbox] = 1
        target_bboxes[:num_bbox] = instance_bboxes[:M, 0:6]

        # ---- augmentation (lib/dataset.py:395-425) ----
        if self.augment:
            flip_yz = bool(rng.random_sample() > 0.5)
            if flip_yz:
                target_bboxes[:, 0] = -target_bboxes[:, 0]
            flip_xz = bool(rng.random_sample() > 0.5)
            if flip_xz:
                target_bboxes[:, 1] = -target_bboxes[:, 1]
            rot_total = np.eye(3)
            for rot_fn, axis in ((rotx, "x"), (roty, "y"), (rotz, "z")):
                angle = rng.random_sample() * np.pi / 18 - np.pi / 36  # ±5°
                rot = rot_fn(angle)
                rot_total = rot @ rot_total   # applied x->y->z, like the loop
                target_bboxes = rotate_aligned_boxes_along_axis(
                    target_bboxes, rot, axis)
            # translation ±0.5 m (lib/dataset.py:_translate)
            factor = rng.choice(np.arange(-0.5, 0.501, 0.001), size=3)
            target_bboxes[:, 0:3] += factor
            # flips + composed rotation + translation on the points in one
            # native pass (box math above is tiny and stays in numpy)
            point_cloud = native.augment_points(
                point_cloud, flip_yz, flip_xz, rot_total, factor)

        # ---- votes AFTER augmentation (lib/dataset.py:427-442) ----
        care = np.isin(semantic_labels, SCANNET_NYU40IDS)
        point_votes, point_votes_mask = native.point_votes(
            point_cloud[:, :3], instance_labels, care)
        point_votes = np.tile(point_votes, (1, 3))

        class_ind = [DC_NYU2CLS[int(x)] for x in instance_bboxes[:num_bbox, -2]]
        size_classes[:num_bbox] = class_ind
        size_residuals[:num_bbox] = (target_bboxes[:num_bbox, 3:6]
                                     - SCANNET_MEAN_SIZE_ARR[class_ind])

        # ---- reference target + GT corners (lib/dataset.py:451-480) ----
        gt_box_corner_label = np.zeros((M, 8, 3))
        gt_box_masks = np.zeros((M,))
        gt_box_object_ids = np.zeros((M,))
        for i, gt_id in enumerate(instance_bboxes[:num_bbox, -1]):
            if gt_id == object_id:
                ref_box_label[i] = 1
                ref_center_label = target_bboxes[i, 0:3]
                ref_heading_class_label = angle_classes[i]
                ref_heading_residual_label = angle_residuals[i]
                ref_size_class_label = size_classes[i]
                ref_size_residual_label = size_residuals[i]
                obb = param2obb_batch(
                    ref_center_label[None], np.array([int(ref_heading_class_label)]),
                    np.array([ref_heading_residual_label]),
                    np.array([int(ref_size_class_label)]),
                    ref_size_residual_label[None])[0]
                ref_box_corner_label = _get_3d_box_batch_np(
                    obb[3:6][None], obb[6][None], obb[0:3][None])[0]
        all_obb = param2obb_batch(
            target_bboxes[:num_bbox, 0:3], angle_classes[:num_bbox].astype(np.int64),
            angle_residuals[:num_bbox], size_classes[:num_bbox].astype(np.int64),
            size_residuals[:num_bbox])
        gt_box_corner_label[:num_bbox] = _get_3d_box_batch_np(
            all_obb[:, 3:6], all_obb[:, 6], all_obb[:, 0:3])
        gt_box_masks[:num_bbox] = 1
        gt_box_object_ids[:num_bbox] = instance_bboxes[:num_bbox, -1]

        target_bboxes_semcls = np.zeros((M,))
        target_object_ids = np.zeros((M,))
        target_bboxes_semcls[:num_bbox] = class_ind
        target_object_ids[:num_bbox] = instance_bboxes[:num_bbox, -1]

        # ---- scan2cad rotations (lib/dataset.py:489-501) ----
        rotations = np.zeros((M, 3, 3))
        rotation_masks = np.zeros((M,))
        if self.scan2cad_rotation and scene_id in self.scan2cad_rotation:
            for i, instance_id in enumerate(
                    instance_bboxes[:num_bbox, -1].astype(int)):
                try:
                    rotations[i] = np.array(
                        self.scan2cad_rotation[scene_id][str(instance_id)])
                    rotation_masks[i] = 1
                except KeyError:
                    pass

        return {
            "point_clouds": point_cloud.astype(np.float32),
            "lang_feat": lang_feat.astype(np.float32),
            "lang_len": np.int32(min(lang_len, self.max_des_len + 2)),
            "lang_ids": lang_ids.astype(np.int32),
            "center_label": target_bboxes[:, 0:3].astype(np.float32),
            "heading_class_label": angle_classes.astype(np.int32),
            "heading_residual_label": angle_residuals.astype(np.float32),
            "size_class_label": size_classes.astype(np.int32),
            "size_residual_label": size_residuals.astype(np.float32),
            "num_bbox": np.int32(num_bbox),
            "sem_cls_label": target_bboxes_semcls.astype(np.int32),
            "scene_object_ids": target_object_ids.astype(np.int32),
            "scene_object_rotations": rotations.astype(np.float32),
            "scene_object_rotation_masks": rotation_masks.astype(np.int32),
            "box_label_mask": target_bboxes_mask.astype(np.float32),
            "vote_label": point_votes.astype(np.float32),
            "vote_label_mask": point_votes_mask.astype(np.int32),
            "dataset_idx": np.int32(idx),
            "ref_box_label": ref_box_label.astype(np.int32),
            "ref_center_label": ref_center_label.astype(np.float32),
            "ref_heading_class_label": np.int32(ref_heading_class_label),
            "ref_heading_residual_label": np.int32(ref_heading_residual_label),
            "ref_size_class_label": np.int32(ref_size_class_label),
            "ref_size_residual_label": ref_size_residual_label.astype(np.float32),
            "ref_box_corner_label": ref_box_corner_label.astype(np.float32),
            "gt_box_corner_label": gt_box_corner_label.astype(np.float32),
            "gt_box_masks": gt_box_masks.astype(np.int32),
            "gt_box_object_ids": gt_box_object_ids.astype(np.int32),
            "object_id": np.int32(object_id),
            "ann_id": np.int32(ann_id),
            "object_cat": np.int32(
                SCANNET_TYPE2CLASS.get(object_name, 17)),
            "load_time": np.float32(time.time() - start),
        }


# nyu40 id -> 18-class mapping used for size/sem classes: built from the ids
# themselves — each nyu40 id kept for detection maps to the 18-class id of
# its canonical name; "others" (17) for everything unnamed
# (model_util_scannet.py:101-116 builds this from the label tsv; the 18
# canonical rows below are the nyu40 ids of the named classes).
_NYU2CLS_NAMED = {
    3: 0,   # cabinet
    4: 1,   # bed
    5: 2,   # chair
    6: 3,   # sofa
    7: 4,   # table
    8: 5,   # door
    9: 6,   # window
    10: 7,  # bookshelf
    11: 8,  # picture
    12: 9,  # counter
    14: 10, # desk
    16: 11, # curtain
    24: 12, # refrigerator
    28: 13, # shower curtain
    33: 14, # toilet
    34: 15, # sink
    36: 16, # bathtub
}
DC_NYU2CLS = {int(i): _NYU2CLS_NAMED.get(int(i), 17) for i in SCANNET_NYU40IDS}


def _collate(samples):
    """Preallocate-and-assign batch assembly.  np.stack is 20-30x slower
    than a memcpy loop for these wide (40000, C) rows on this numpy (it
    routes per-array strided copies through the slow concatenate path) —
    at B=16 multiview shapes that's >1s per batch vs ~0.1s."""
    batch = {}
    for k, v0 in samples[0].items():
        v0 = np.asarray(v0)
        out = np.empty((len(samples),) + v0.shape, v0.dtype)
        for i, s in enumerate(samples):
            out[i] = s[k]
        batch[k] = out
    return batch


class Loader:
    """Thread-pool prefetching batch loader (replaces torch DataLoader).

    Multi-host data parallelism: pass ``num_shards``/``shard_id`` (the
    number of hosts and this host's rank) and every host draws the
    SAME seeded global permutation but keeps only its interleaved slice, so
    the union of all hosts' batches covers each epoch exactly once with no
    overlap — the per-host input pipeline the reference never needed
    (SURVEY.md §2.4; its DataLoader feeds a single GPU).

    A rank of a mesh (``parallel.mesh``) passes ``data_shard=(d, DATA)``:
    it loads only rows [d * B / DATA, (d + 1) * B / DATA) of each global
    batch, the very batch (items, order and augmentation seeds) that one
    process draws, and yields those rows.  B must divide by DATA."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 42, num_workers: int = 4, drop_last: bool = True,
                 num_shards: int = 1, shard_id: int = 0,
                 reuse_buffers: bool = False,
                 data_shard: Optional[Tuple[int, int]] = None):
        assert 0 <= shard_id < num_shards
        d, n_data = data_shard or (0, 1)
        if batch_size % n_data or not 0 <= d < n_data or (
                n_data > 1 and not drop_last):
            raise ValueError(f"data_shard={data_shard} needs drop_last and "
                             f"a batch size ({batch_size}) it divides")
        # the rows of each global batch this loader yields
        self.rows = slice(d * batch_size // n_data,
                          (d + 1) * batch_size // n_data)
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.num_shards = num_shards
        self.shard_id = shard_id
        self.epoch = 0
        # Opt-in ring of reusable batch buffers: workers write samples
        # directly into PREFETCH_BATCHES+2 preallocated batch arrays, so
        # after the first cycle no fresh pages are ever allocated.  Touching
        # fresh pages is the measured bottleneck of the retained-batch path
        # (fault-in of a new 21.6 MB point_clouds array costs ~25 ms/MB on
        # this class of VM vs ~0.1 ms/MB for allocator-reused pages).
        # CONTRACT: a yielded batch is only valid until two more batches
        # have been consumed — copy (or upload to device, as the train loop
        # does) before then.  The slot counter persists across epochs
        # (self._ring_pos) so the window also holds over an epoch boundary:
        # a consumer still holding the last batch of epoch N is not
        # overwritten by epoch N+1's initial prefetch.  Off by default.
        self.reuse_buffers = reuse_buffers
        self._ring_pos = 0
        # worker pool + buffer ring live on the INSTANCE so the
        # zero-fresh-page steady state survives across epochs (shapes are
        # static; rebuilding them per __iter__ re-paid seconds of page
        # faults at every epoch start on fault-throttled hosts)
        self._pool = None
        self._buffers = None
        self._inflight = deque()

    def close(self):
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None

    def __del__(self):  # pragma: no cover
        self.close()

    def _shard_size(self):
        # every host must run the same number of steps: floor division
        # (the tail remainder of < num_shards samples per epoch is dropped)
        return len(self.dataset) // self.num_shards if self.num_shards > 1 \
            else len(self.dataset)

    def __len__(self):
        n = self._shard_size()
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    # batches of decoded samples kept in flight ahead of the consumer;
    # unbounded submission would hold EVERY epoch sample in memory (a
    # Future retains its result) — tens of GB on the real train split
    PREFETCH_BATCHES = 4

    def __iter__(self):
        # consume the epoch on iterator CREATION: a consumer that breaks
        # early must never replay the identical permutation/augmentations
        epoch = self.epoch
        self.epoch = epoch + 1
        rs = np.random.RandomState(self.seed + epoch)
        order = np.arange(len(self.dataset))
        if self.shuffle:
            rs.shuffle(order)
        if self.num_shards > 1:
            order = order[self.shard_id::self.num_shards][:self._shard_size()]
        n_batches = len(self)
        nbuf = self.PREFETCH_BATCHES + 2
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=self.num_workers)
        if self._buffers is None:
            self._buffers = [None] * nbuf
        # an early-broken previous epoch may have left workers writing into
        # the shared ring — settle them before reusing the slots
        for _, fs in self._inflight:
            for f in fs:
                f.cancel()
        for _, fs in self._inflight:
            for f in fs:
                if not f.cancelled():
                    try:
                        f.result()
                    except Exception:
                        pass
        self._inflight.clear()
        pool = self._pool
        buffers = self._buffers
        alloc_lock = threading.Lock()

        def write_into(slot, row, i, rs):
            s = self.dataset.__getitem__(i, rs)
            if buffers[slot] is None:
                with alloc_lock:
                    if buffers[slot] is None:
                        buffers[slot] = {
                            k: np.empty(
                                (self.rows.stop - self.rows.start,)
                                + np.asarray(v).shape,
                                np.asarray(v).dtype)
                            for k, v in s.items()}
            buf = buffers[slot]
            for k, v in s.items():
                buf[k][row] = v

        def submit(b):
            idxs = order[b * self.batch_size:(b + 1) * self.batch_size]
            seeds = [(self.seed + epoch) * 100003 + int(i) for i in idxs]
            idxs, seeds = idxs[self.rows], seeds[self.rows]
            if self.reuse_buffers:
                # ring position persists across epochs (see __init__
                # contract): the new epoch's prefetch lands in the slots
                # AFTER the previous epoch's final batches
                slot = self._ring_pos % nbuf
                self._ring_pos += 1
                return slot, [pool.submit(write_into, slot, r, int(i),
                                          np.random.RandomState(sd))
                              for r, (i, sd) in enumerate(zip(idxs, seeds))]
            return None, [pool.submit(self.dataset.__getitem__, int(i),
                                      np.random.RandomState(sd))
                          for i, sd in zip(idxs, seeds)]

        window = self._inflight
        for b in range(min(self.PREFETCH_BATCHES, n_batches)):
            window.append(submit(b))
        for b in range(n_batches):
            slot, fs = window.popleft()
            nxt = b + self.PREFETCH_BATCHES
            if nxt < n_batches:
                window.append(submit(nxt))
            if self.reuse_buffers:
                for f in fs:
                    f.result()          # barrier + error propagation
                buf = buffers[slot]
                yield (buf if len(fs) == self.rows.stop - self.rows.start
                       else {k: v[:len(fs)] for k, v in buf.items()})
            else:
                yield _collate([f.result() for f in fs])


def get_scanrefer(scanrefer_train_path: str, scanrefer_val_path: str,
                  num_scenes: int = -1):
    """Split organization (scripts/train.py:204-273): full train list; eval
    lists contain ONE dummy sample per scene (captions are generated for all
    proposals at eval, so one forward per scene suffices)."""
    with open(scanrefer_train_path) as f:
        scanrefer_train = json.load(f)
    with open(scanrefer_val_path) as f:
        scanrefer_val = json.load(f)

    train_scene_list = sorted({d["scene_id"] for d in scanrefer_train})
    val_scene_list = sorted({d["scene_id"] for d in scanrefer_val})
    if num_scenes > 0:
        train_scene_list = train_scene_list[:num_scenes]
    scanrefer_train = [d for d in scanrefer_train
                       if d["scene_id"] in set(train_scene_list)]

    def one_per_scene(scene_list, source):
        by_scene = {}
        for d in source:
            by_scene.setdefault(d["scene_id"], d)
        return [dict(by_scene[s], ann_id=by_scene[s]["ann_id"])
                for s in scene_list]

    eval_train = one_per_scene(train_scene_list, scanrefer_train)
    eval_val = one_per_scene(val_scene_list, scanrefer_val)
    all_scenes = train_scene_list + val_scene_list
    return scanrefer_train, eval_train, eval_val, all_scenes
