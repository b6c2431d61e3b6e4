"""ScanNet scene preprocessing (a copy of
``scan2cap_tpu/data/scannet_preprocess.py``; reference
data/scannet/load_scannet_data.py + batch_load_scannet_data.py), numpy only.

Per scene, emits the six .npy files the datasets consume:
  <scene>_vert.npy / _aligned_vert.npy   (N, 9): xyz + rgb(0-255) + normal
  <scene>_sem_label.npy                  (N,): nyu40 ids (0 = unannotated)
  <scene>_ins_label.npy                  (N,): 1-indexed instance ids
  <scene>_bbox.npy / _aligned_bbox.npy   (M, 8): cx cy cz dx dy dz sem obj_id

Semantics preserved (load_scannet_data.py:48-155): 1-indexed instances from
the aggregation json, axis-align matrix from the scene meta, per-instance
AABBs in both frames with the object id column = instance_id - 1; batch mode
filters boxes to the detection nyu40 ids and caps scenes at 50k points
(batch_load_scannet_data.py:24-66).
"""

from __future__ import annotations

import csv
import json
import os
from typing import Dict, Optional, Tuple

import numpy as np

from scan2cap_torch.config import SCANNET_NYU40IDS
from scan2cap_torch.utils.pc_utils import compute_normals, random_sampling
from scan2cap_torch.utils.ply import read_ply


def read_label_mapping(tsv_path: str, label_from: str = "raw_category",
                       label_to: str = "nyu40id") -> Dict[str, int]:
    mapping = {}
    with open(tsv_path) as f:
        for row in csv.DictReader(f, delimiter="\t"):
            mapping[row[label_from]] = int(row[label_to])
    return mapping


def read_mesh_vertices_rgb_normal(ply_path: str) -> np.ndarray:
    """(N, 9): xyz, rgb (0-255), area-weighted vertex normals."""
    data = read_ply(ply_path)
    v = data["vertex"]
    xyz = np.stack([v["x"], v["y"], v["z"]], 1).astype(np.float32)
    rgb = np.stack([v["red"], v["green"], v["blue"]], 1).astype(np.float32)
    faces = data.get("face")
    normals = (compute_normals(xyz.astype(np.float64), faces)
               if faces is not None else np.zeros_like(xyz))
    return np.concatenate([xyz, rgb, normals], axis=1)


def read_aggregation(path: str):
    object_id_to_segs, label_to_segs = {}, {}
    with open(path) as f:
        data = json.load(f)
    for group in data["segGroups"]:
        object_id = group["objectId"] + 1  # 1-indexed instances
        object_id_to_segs[object_id] = group["segments"]
        label_to_segs.setdefault(group["label"], []).extend(group["segments"])
    return object_id_to_segs, label_to_segs


def read_segmentation(path: str):
    with open(path) as f:
        seg_indices = json.load(f)["segIndices"]
    seg_to_verts: Dict[int, list] = {}
    for i, seg_id in enumerate(seg_indices):
        seg_to_verts.setdefault(seg_id, []).append(i)
    return seg_to_verts, len(seg_indices)


def read_axis_align_matrix(meta_path: str) -> Optional[np.ndarray]:
    if not os.path.exists(meta_path):
        return None
    for line in open(meta_path):
        if "axisAlignment" in line:
            vals = [float(x) for x in
                    line.rstrip().strip("axisAlignment = ").split(" ")]
            return np.asarray(vals).reshape(4, 4)
    return None


def _instance_bboxes(vertices, instance_ids, object_id_to_label_id,
                     object_id_to_segs) -> np.ndarray:
    num_instances = len(object_id_to_segs)
    bboxes = np.zeros((num_instances, 8))
    for obj_id in object_id_to_segs:
        obj_pc = vertices[instance_ids == obj_id, 0:3]
        if len(obj_pc) == 0:
            continue
        lo, hi = obj_pc.min(0), obj_pc.max(0)
        bboxes[obj_id - 1] = [*((lo + hi) / 2), *(hi - lo),
                              object_id_to_label_id[obj_id], obj_id - 1]
    return bboxes


def export(mesh_file: str, agg_file: str, seg_file: str, meta_file: str,
           label_map_file: str, output_file: Optional[str] = None):
    """One scene → (vertices, aligned, sem, ins, bboxes, aligned_bboxes)."""
    label_map = read_label_mapping(label_map_file)
    mesh_vertices = read_mesh_vertices_rgb_normal(mesh_file)

    axis_align = read_axis_align_matrix(meta_file)
    if axis_align is not None:
        pts = np.ones((len(mesh_vertices), 4))
        pts[:, 0:3] = mesh_vertices[:, 0:3]
        aligned = mesh_vertices.copy()
        aligned[:, 0:3] = (pts @ axis_align.T)[:, 0:3]
    else:
        aligned = mesh_vertices

    if os.path.isfile(agg_file):
        object_id_to_segs, label_to_segs = read_aggregation(agg_file)
        seg_to_verts, num_verts = read_segmentation(seg_file)
        label_ids = np.zeros(num_verts, np.uint32)
        object_id_to_label_id = {}
        for label, segs in label_to_segs.items():
            label_id = label_map.get(label, 0)
            for seg in segs:
                label_ids[seg_to_verts[seg]] = label_id
        instance_ids = np.zeros(num_verts, np.uint32)
        for object_id, segs in object_id_to_segs.items():
            for seg in segs:
                verts = seg_to_verts[seg]
                instance_ids[verts] = object_id
                if object_id not in object_id_to_label_id:
                    object_id_to_label_id[object_id] = label_ids[verts[0]]
        bboxes = _instance_bboxes(mesh_vertices, instance_ids,
                                  object_id_to_label_id, object_id_to_segs)
        aligned_bboxes = _instance_bboxes(aligned, instance_ids,
                                          object_id_to_label_id,
                                          object_id_to_segs)
    else:  # test scenes have no annotations
        num_verts = len(mesh_vertices)
        label_ids = np.zeros(num_verts, np.uint32)
        instance_ids = np.zeros(num_verts, np.uint32)
        bboxes = np.zeros((1, 8))
        aligned_bboxes = np.zeros((1, 8))

    if output_file is not None:
        np.save(output_file + "_vert.npy", mesh_vertices)
        np.save(output_file + "_aligned_vert.npy", aligned)
        np.save(output_file + "_sem_label.npy", label_ids)
        np.save(output_file + "_ins_label.npy", instance_ids)
        np.save(output_file + "_bbox.npy", bboxes)
        np.save(output_file + "_aligned_bbox.npy", aligned_bboxes)
    return mesh_vertices, aligned, label_ids, instance_ids, bboxes, aligned_bboxes


def batch_export(scan_dir: str, out_dir: str, label_map_file: str,
                 scene_list=None, max_num_points: int = 50000,
                 seed: int = 0):
    """batch_load_scannet_data.py:24-66: filter boxes to detection classes,
    cap scenes at 50k points (random subsample), write 6 npys per scene."""
    os.makedirs(out_dir, exist_ok=True)
    scenes = scene_list or sorted(os.listdir(scan_dir))
    rs = np.random.RandomState(seed)
    done = []
    for scan_name in scenes:
        out_prefix = os.path.join(out_dir, scan_name)
        if os.path.exists(out_prefix + "_aligned_bbox.npy"):
            done.append(scan_name)
            continue
        base = os.path.join(scan_dir, scan_name, scan_name)
        mesh_vertices, aligned, label_ids, instance_ids, bboxes, abboxes = \
            export(base + "_vh_clean_2.ply", base + ".aggregation.json",
                   base + "_vh_clean_2.0.010000.segs.json", base + ".txt",
                   label_map_file)

        # keep only detection classes' boxes
        mask = np.isin(bboxes[:, -2], SCANNET_NYU40IDS)
        bboxes = bboxes[mask]
        abboxes = abboxes[np.isin(abboxes[:, -2], SCANNET_NYU40IDS)]

        if len(mesh_vertices) > max_num_points:
            _, choices = random_sampling(mesh_vertices, max_num_points,
                                         replace=False, return_choices=True,
                                         rs=rs)
            mesh_vertices = mesh_vertices[choices]
            aligned = aligned[choices]
            label_ids = label_ids[choices]
            instance_ids = instance_ids[choices]

        np.save(out_prefix + "_vert.npy", mesh_vertices)
        np.save(out_prefix + "_aligned_vert.npy", aligned)
        np.save(out_prefix + "_sem_label.npy", label_ids)
        np.save(out_prefix + "_ins_label.npy", instance_ids)
        np.save(out_prefix + "_bbox.npy", bboxes)
        np.save(out_prefix + "_aligned_bbox.npy", abboxes)
        done.append(scan_name)
    return done
