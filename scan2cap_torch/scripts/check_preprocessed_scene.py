"""Look at a preprocessed scene:
``python -m scan2cap_torch.scripts.check_preprocessed_scene`` (counterpart
of ``scripts/check_preprocessed_scene.py``; reference
data/scannet/visualize.py).

Writes ``<out>/<scene>_points.ply`` (the points of
``<scene>_aligned_vert.npy`` in their colours) and ``<out>/<scene>_boxes.ply``
(the boxes of ``<scene>_aligned_bbox.npy`` in red).

Run: python -m scan2cap_torch.scripts.check_preprocessed_scene \\
        --scannet_data <scannet_data/> --scene_id scene0000_00 --out <dir>
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from scan2cap_torch.utils.pc_utils import write_bbox_ply
from scan2cap_torch.utils.ply import write_ply


def box_corners(bboxes: np.ndarray) -> np.ndarray:
    """(M, >=6) centre and size rows -> (M, 8, 3) axis-aligned corners in
    the order ``write_bbox_ply`` draws."""
    sx = np.array([1, 1, -1, -1, 1, 1, -1, -1])
    sy = np.array([1, -1, -1, 1, 1, -1, -1, 1])
    sz = np.array([1, 1, 1, 1, -1, -1, -1, -1])
    return np.stack([
        b[:3] + np.stack([sx * b[3] / 2, sy * b[4] / 2, sz * b[5] / 2], 1)
        for b in bboxes])


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--scannet_data", type=str, required=True)
    p.add_argument("--scene_id", type=str, required=True)
    p.add_argument("--out", type=str, required=True)
    args = p.parse_args(argv)

    base = os.path.join(args.scannet_data, args.scene_id)
    verts = np.load(base + "_aligned_vert.npy")
    bboxes = np.load(base + "_aligned_bbox.npy")

    os.makedirs(args.out, exist_ok=True)
    write_ply(os.path.join(args.out, f"{args.scene_id}_points.ply"),
              verts[:, :3].astype(np.float32),
              verts[:, 3:6].clip(0, 255).astype(np.uint8))
    write_bbox_ply(os.path.join(args.out, f"{args.scene_id}_boxes.ply"),
                   box_corners(bboxes), color=(255, 0, 0))
    print(f"wrote {len(verts)} points, {len(bboxes)} boxes to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
