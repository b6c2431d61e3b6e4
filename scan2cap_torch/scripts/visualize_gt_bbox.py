"""A scene's ground-truth boxes without a model:
``python -m scan2cap_torch.scripts.visualize_gt_bbox`` (counterpart of
``scripts/visualize_gt_bbox.py``).

Writes ``<out>/<scene>.ply`` (the points of
``<data>/scannet/scannet_data/<scene>_aligned_vert.npy`` in their colours)
and ``<out>/<scene>_gt_bbox.ply`` (its boxes in blue).

Run: python -m scan2cap_torch.scripts.visualize_gt_bbox \\
        --scene_id scene0000_00 --out <dir> [--data <SCAN2CAP_DATA>]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from scan2cap_torch.config import PathConfig
from scan2cap_torch.scripts.check_preprocessed_scene import box_corners
from scan2cap_torch.utils.pc_utils import write_bbox_ply
from scan2cap_torch.utils.ply import write_ply


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--scene_id", type=str, required=True)
    p.add_argument("--data", type=str, default=PathConfig().data)
    p.add_argument("--out", type=str, required=True)
    args = p.parse_args(argv)

    base = os.path.join(args.data, "scannet", "scannet_data", args.scene_id)
    verts = np.load(base + "_aligned_vert.npy")
    bboxes = np.load(base + "_aligned_bbox.npy")

    os.makedirs(args.out, exist_ok=True)
    write_ply(os.path.join(args.out, f"{args.scene_id}.ply"),
              verts[:, :3].astype(np.float32),
              verts[:, 3:6].clip(0, 255).astype(np.uint8))
    write_bbox_ply(os.path.join(args.out, f"{args.scene_id}_gt_bbox.ply"),
                   box_corners(bboxes), color=(0, 0, 255))
    print(f"wrote {len(bboxes)} GT boxes for {args.scene_id} to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
