"""Scan2CAD alignments as per-instance rotations:
``python -m scan2cap_torch.scripts.scan2cad_to_scannet`` (counterpart of
``scripts/scan2cad_to_scannet.py``; reference scripts/Scan2CAD_to_ScanNet.py).

Reads ``full_annotations.json`` and ``aligned_cad2inst_id.json`` from
``--scan2cad`` and writes ``{scene_id: {instance_id: 3x3 rotation}}``, the
``scannet_instance_rotations.json`` that ``--use_orientation`` reads.

Run: python -m scan2cap_torch.scripts.scan2cad_to_scannet \\
        --scan2cad <dir> --out <data>/scannet_instance_rotations.json
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def quat_to_matrix(w: float, x: float, y: float, z: float) -> np.ndarray:
    """Unit-quaternion (w, x, y, z) -> 3x3 rotation matrix."""
    n = np.sqrt(w * w + x * x + y * y + z * z)
    if n == 0:
        return np.eye(3)
    w, x, y, z = w / n, x / n, y / n, z / n
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def parse(scan2cad, aligned_cad2inst):
    """Every aligned CAD model with an instance id -> its rotation."""
    parsed = {}
    for scan in scan2cad:
        scene_id = scan["id_scan"]
        for cad_id, cad in enumerate(scan["aligned_models"]):
            try:
                rot = quat_to_matrix(*cad["trs"]["rotation"])
                instance_id = aligned_cad2inst[scene_id][str(cad_id)]
                parsed.setdefault(scene_id, {})[str(instance_id)] = \
                    rot.tolist()
            except KeyError:
                pass
    return parsed


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--scan2cad", type=str, required=True,
                   help="dir with full_annotations.json + "
                        "aligned_cad2inst_id.json")
    p.add_argument("--out", type=str, required=True)
    args = p.parse_args(argv)
    with open(os.path.join(args.scan2cad, "full_annotations.json")) as f:
        scan2cad = json.load(f)
    with open(os.path.join(args.scan2cad, "aligned_cad2inst_id.json")) as f:
        cad2inst = json.load(f)
    parsed = parse(scan2cad, cad2inst)
    with open(args.out, "w") as f:
        json.dump(parsed, f, indent=4)
    print(f"wrote rotations for {len(parsed)} scenes to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
