"""Project per-frame 2D semantic labels onto a scene's points for a visual
check: ``python -m scan2cap_torch.scripts.project_multiview_labels``
(counterpart of ``scripts/project_multiview_labels.py``).

The projection of ``project_multiview_features`` (every ``--frame_skip``-th
pose, the depth-consistency check), a majority vote over the frames that
see a point (ties to the lower class; unseen points get class 0), and a PLY
of the points coloured by NYU40 class: class 0 black, classes 1 to 20 the
first 20 colours of ``utils/colors.py``.  Labels are (H, W) integer ``.npy``
files at the projector's 41 x 32.
"""

from __future__ import annotations

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--scannet_data", type=str, required=True)
    p.add_argument("--frames_root", type=str, required=True)
    p.add_argument("--labels_root", type=str, required=True,
                   help="per-frame label npys at the projector's size")
    p.add_argument("--scene_id", type=str, required=True)
    p.add_argument("--out", type=str, required=True, help="output ply")
    p.add_argument("--frame_skip", type=int, default=20)
    return p


def main(argv=None) -> int:
    import numpy as np

    from scan2cap_torch.data.frames import load_depth, load_pose
    from scan2cap_torch.data.projection import (
        DEPTH_MAX, DEPTH_MIN, PROJECTION_ACCURACY, PROJECTOR_IMAGE_DIMS,
        SCANNET_INTRINSICS, ProjectionHelper)
    from scan2cap_torch.utils.colors import NYU40_COLORS
    from scan2cap_torch.utils.ply import write_ply

    palette = np.concatenate([np.zeros((1, 3), np.uint8),
                              np.asarray(NYU40_COLORS[:20], np.uint8)])
    args = build_parser().parse_args(argv)
    projector = ProjectionHelper(SCANNET_INTRINSICS, DEPTH_MIN, DEPTH_MAX,
                                 PROJECTOR_IMAGE_DIMS, PROJECTION_ACCURACY)
    verts = np.load(os.path.join(args.scannet_data,
                                 args.scene_id + "_aligned_vert.npy"))
    points = verts[:, :3]
    N = len(points)
    votes = np.zeros((N, 41), np.int32)

    pose_dir = os.path.join(args.frames_root, args.scene_id, "pose")
    depth_dir = os.path.join(args.frames_root, args.scene_id, "depth")
    label_dir = os.path.join(args.labels_root, args.scene_id)
    for f in sorted(os.listdir(pose_dir))[::args.frame_skip]:
        frame_id = os.path.splitext(f)[0]
        label_path = os.path.join(label_dir, frame_id + ".npy")
        if not os.path.exists(label_path):
            continue
        pose = load_pose(os.path.join(pose_dir, f))
        depth = load_depth(os.path.join(depth_dir, frame_id + ".png"),
                           PROJECTOR_IMAGE_DIMS)
        proj = projector.compute_projection(points, depth, pose)
        if proj is None:
            continue
        ind3d, ind2d = proj
        labels = np.load(label_path)                          # (H, W) int
        scat = projector.project(labels.astype(np.float32)[None],
                                 ind3d, ind2d, N)[0].astype(int)
        hit = np.zeros(N, bool)
        hit[ind3d[1:1 + ind3d[0]]] = True
        votes[hit, np.clip(scat[hit], 0, 40)] += 1

    assigned = votes.argmax(-1)
    assigned[votes.sum(-1) == 0] = 0
    rgb = palette[np.clip(assigned, 0, len(palette) - 1)]
    write_ply(args.out, points.astype(np.float32), rgb)
    print(f"wrote {args.out} ({int((votes.sum(-1) > 0).sum())}/{N} labeled)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
