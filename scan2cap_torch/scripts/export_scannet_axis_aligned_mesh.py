"""Axis-aligned ScanNet meshes:
``python -m scan2cap_torch.scripts.export_scannet_axis_aligned_mesh``
(counterpart of ``scripts/export_scannet_axis_aligned_mesh.py``).

Applies each scene's axisAlignment matrix (``<scene>.txt``) to its
``_vh_clean_2.ply`` and writes ``<out>/<scene>_aligned.ply`` with the
colours and faces of the input.

Run: python -m scan2cap_torch.scripts.export_scannet_axis_aligned_mesh \\
        --scans <ScanNet scans/> --out <dir> [--scene_id scene0000_00]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from scan2cap_torch.data.scannet_preprocess import read_axis_align_matrix
from scan2cap_torch.utils.ply import read_ply, write_ply


def export_scene(scan_dir: str, scene_id: str, out_dir: str) -> str:
    base = os.path.join(scan_dir, scene_id, scene_id)
    data = read_ply(base + "_vh_clean_2.ply")
    v = data["vertex"]
    xyz = np.stack([v["x"], v["y"], v["z"]], 1).astype(np.float64)
    rgb = np.stack([v["red"], v["green"], v["blue"]], 1).astype(np.uint8)
    faces = data.get("face")

    mat = read_axis_align_matrix(base + ".txt")
    if mat is not None:
        pts = np.ones((len(xyz), 4))
        pts[:, :3] = xyz
        xyz = (pts @ mat.T)[:, :3]

    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, scene_id + "_aligned.ply")
    write_ply(out, xyz.astype(np.float32), rgb, faces)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--scans", type=str, required=True)
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--scene_id", type=str, default=None,
                   help="single scene; default: all scenes in --scans")
    args = p.parse_args(argv)
    scenes = ([args.scene_id] if args.scene_id
              else sorted(os.listdir(args.scans)))
    for s in scenes:
        print(export_scene(args.scans, s, args.out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
