"""Project per-frame ENet features onto scene points:
``python -m scan2cap_torch.scripts.project_multiview_features``
(counterpart of ``scripts/project_multiview_features.py``).

For every scene of ``--scannet_data`` (``<scene_id>_aligned_vert.npy``):
take every ``--frame_skip``-th pose, find each frame's point -> pixel
correspondence with the depth-consistency check (``data/projection.py``,
numpy on the host), scatter the frame's 128-channel features onto those
points, and aggregate across frames: with ``--maxpool`` the first frame to
cover a point fills it and later ones max-pool, without it the first frame
alone counts.  Writes the port's feature store (``data/feature_store.py``),
one (N, 128) float32 array per ``scene_id``, where the JAX script writes
HDF5 (``convert_feature_db`` turns one into the other).  The default output
is ``enet_feats_maxpool.npz`` under ``SCAN2CAP_DATA``'s scannet data, the
file ``config.PathConfig.multiview`` reads.  The last line is a JSON object
of counts and times.
"""

from __future__ import annotations

import argparse
import json
import os
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--scannet_data", type=str, required=True,
                   help="dir with <scene>_aligned_vert.npy files")
    p.add_argument("--frames_root", type=str, required=True,
                   help="<root>/<scene>/{depth,pose}/<frame> layout")
    p.add_argument("--features_root", type=str, required=True,
                   help="per-frame ENet feature npys")
    p.add_argument("--out", type=str, default=None,
                   help="the store to write (default: "
                        "<SCAN2CAP_DATA>/scannet/scannet_data/"
                        "enet_feats_maxpool.npz)")
    p.add_argument("--maxpool", action="store_true")
    p.add_argument("--frame_skip", type=int, default=20)
    return p


def main(argv=None) -> int:
    import numpy as np

    from scan2cap_torch.config import PathConfig
    from scan2cap_torch.data.feature_store import FeatureStoreWriter
    from scan2cap_torch.data.frames import load_depth, load_pose
    from scan2cap_torch.data.projection import (
        DEPTH_MAX, DEPTH_MIN, PROJECTION_ACCURACY, PROJECTOR_IMAGE_DIMS,
        SCANNET_INTRINSICS, ProjectionHelper)

    args = build_parser().parse_args(argv)
    out = args.out or os.path.join(PathConfig().scannet_data,
                                   "enet_feats_maxpool.npz")
    projector = ProjectionHelper(SCANNET_INTRINSICS, DEPTH_MIN, DEPTH_MAX,
                                 PROJECTOR_IMAGE_DIMS, PROJECTION_ACCURACY)

    scenes = sorted(
        f[:-len("_aligned_vert.npy")] for f in os.listdir(args.scannet_data)
        if f.endswith("_aligned_vert.npy"))
    frames_projected = points_covered = points_total = 0
    project_s = 0.0
    t_all = time.perf_counter()
    with FeatureStoreWriter(out) as db:
        for scene_id in scenes:
            verts = np.load(os.path.join(args.scannet_data,
                                         scene_id + "_aligned_vert.npy"))
            points = verts[:, :3]
            N = len(points)
            agg = np.zeros((N, 128), np.float32)
            written = np.zeros(N, bool)

            pose_dir = os.path.join(args.frames_root, scene_id, "pose")
            depth_dir = os.path.join(args.frames_root, scene_id, "depth")
            feat_dir = os.path.join(args.features_root, scene_id)
            if not os.path.isdir(pose_dir):
                continue
            for f in sorted(os.listdir(pose_dir))[::args.frame_skip]:
                frame_id = os.path.splitext(f)[0]
                feat_path = os.path.join(feat_dir, frame_id + ".npy")
                if not os.path.exists(feat_path):
                    continue
                pose = load_pose(os.path.join(pose_dir, f))
                depth = load_depth(os.path.join(depth_dir, frame_id + ".png"),
                                   PROJECTOR_IMAGE_DIMS)
                t0 = time.perf_counter()
                proj = projector.compute_projection(points, depth, pose)
                project_s += time.perf_counter() - t0
                frames_projected += 1
                if proj is None:
                    continue
                ind3d, ind2d = proj
                feat = np.load(feat_path)                     # (128, H, W)
                scattered = projector.project(feat, ind3d, ind2d, N).T
                hit = np.zeros(N, bool)
                hit[ind3d[1:1 + ind3d[0]]] = True
                # the first coverage fills; with --maxpool a repeat one
                # max-pools (against the zero start it would clamp the
                # negative PReLU channels)
                first = hit & ~written
                agg[first] = scattered[first]
                if args.maxpool:
                    again = hit & written
                    agg[again] = np.maximum(agg[again], scattered[again])
                written |= hit
            db[scene_id] = agg
            points_covered += int(written.sum())
            points_total += N
            print(f"{scene_id}: {int(written.sum())}/{N} points covered",
                  flush=True)
    print(f"wrote {out}", flush=True)
    print(json.dumps({"project_multiview_features": {
        "scenes": len(scenes), "frames_projected": frames_projected,
        "projection_s": project_s,
        "projection_ms_per_frame": (project_s / frames_projected * 1e3
                                    if frames_projected else None),
        "points_covered": points_covered, "points": points_total,
        "store_bytes": os.path.getsize(out),
        "total_s": time.perf_counter() - t_all}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
