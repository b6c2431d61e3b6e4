"""GT corner boxes per annotation for the offline benchmark:
``python -m scan2cap_torch.scripts.build_benchmark_gt`` (copy of
``scripts/build_benchmark_gt.py``).  Writes
``ScanRefer_filtered_<split>_gt_bbox.json`` under ``--data`` (default
``SCAN2CAP_DATA``, else ``data``): the ScanRefer entries with an added
"bbox" (8, 3) corner list from the scenes' aligned instance boxes."""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def get_3d_box_np(size, center):
    sx = np.array([1, 1, -1, -1, 1, 1, -1, -1]) * size[0] / 2
    sy = np.array([1, -1, -1, 1, 1, -1, -1, 1]) * size[1] / 2
    sz = np.array([1, 1, 1, 1, -1, -1, -1, -1]) * size[2] / 2
    return np.stack([sx, sy, sz], 1) + center


def build_gt(scanrefer, scannet_data_dir):
    scene_list = sorted({d["scene_id"] for d in scanrefer})
    scene_data = {}
    for scene_id in scene_list:
        boxes = np.load(os.path.join(scannet_data_dir,
                                     scene_id + "_aligned_bbox.npy"))
        scene_data[scene_id] = {
            str(int(b[-1])): get_3d_box_np(b[3:6], b[:3]) for b in boxes}
    out = []
    for d in scanrefer:
        bbox = scene_data[d["scene_id"]].get(d["object_id"])
        if bbox is None:
            continue
        entry = dict(d)
        entry["bbox"] = bbox.tolist()
        out.append(entry)
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--split", type=str, default="val",
                   choices=["train", "val", "test"])
    p.add_argument("--data", type=str,
                   default=os.environ.get("SCAN2CAP_DATA", "data"))
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    with open(os.path.join(
            args.data, f"ScanRefer_filtered_{args.split}.json")) as f:
        scanrefer = json.load(f)
    out = build_gt(scanrefer,
                   os.path.join(args.data, "scannet", "scannet_data"))
    out_path = os.path.join(
        args.data, f"ScanRefer_filtered_{args.split}_gt_bbox.json")
    with open(out_path, "w") as f:
        json.dump(out, f, indent=4)
    print(f"wrote {len(out)} GT boxes to {out_path}")
    return out_path


if __name__ == "__main__":
    main()
