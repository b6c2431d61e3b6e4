"""Multiview 3D <-> 2D projection (a numpy copy of
``scan2cap_tpu/data/projection.py``; reference lib/projection.py).

Offline preprocessing, once per scene, on the host:

* frustum corners from float64 intrinsics and the depth range;
* inward plane normals and the point-in-frustum test with the reference's
  round-to-2-decimals predicate;
* each frame's point -> pixel correspondence (``np.round`` pixel snapping)
  with the depth-consistency check (|depth(pixel) - z_cam| <= accuracy),
  in the reference's fixed-size encoding: the valid count in slot 0;
* ``project``: scatter 2D features onto the corresponding points.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


class ProjectionHelper:
    def __init__(self, intrinsic: np.ndarray, depth_min: float,
                 depth_max: float, image_dims: Tuple[int, int],
                 accuracy: float):
        self.intrinsic = np.asarray(intrinsic, np.float64)
        self.depth_min = depth_min
        self.depth_max = depth_max
        self.image_dims = image_dims   # (width, height)
        self.accuracy = accuracy
        self.corner_points = self._compute_corner_points()

    def depth_to_skeleton(self, ux: float, uy: float, depth: float) -> np.ndarray:
        x = (ux - self.intrinsic[0][2]) / self.intrinsic[0][0]
        y = (uy - self.intrinsic[1][2]) / self.intrinsic[1][1]
        return np.asarray([depth * x, depth * y, depth])

    def skeleton_to_depth(self, p: np.ndarray) -> np.ndarray:
        x = (p[0] * self.intrinsic[0][0]) / p[2] + self.intrinsic[0][2]
        y = (p[1] * self.intrinsic[1][1]) / p[2] + self.intrinsic[1][2]
        return np.asarray([x, y, p[2]])

    def _compute_corner_points(self) -> np.ndarray:
        w, h = self.image_dims
        corners = np.ones((8, 4))
        for i, (ux, uy, d) in enumerate([
            (0, 0, self.depth_min), (w - 1, 0, self.depth_min),
            (w - 1, h - 1, self.depth_min), (0, h - 1, self.depth_min),
            (0, 0, self.depth_max), (w - 1, 0, self.depth_max),
            (w - 1, h - 1, self.depth_max), (0, h - 1, self.depth_max),
        ]):
            corners[i, :3] = self.depth_to_skeleton(ux, uy, d)
        return corners

    def compute_frustum_corners(self, camera_to_world: np.ndarray) -> np.ndarray:
        return (camera_to_world @ self.corner_points.T).T   # (8, 4)

    def compute_frustum_normals(self, corners: np.ndarray) -> np.ndarray:
        c = corners[:, :3]
        pairs = [
            (c[3] - c[0], c[1] - c[0]),  # front
            (c[2] - c[1], c[5] - c[1]),  # right
            (c[3] - c[2], c[6] - c[2]),  # roof
            (c[0] - c[3], c[7] - c[3]),  # left
            (c[1] - c[0], c[4] - c[0]),  # bottom
            (c[6] - c[5], c[4] - c[5]),  # back
        ]
        return np.stack([np.cross(a, b) for a, b in pairs])

    def points_in_frustum(self, corners: np.ndarray, normals: np.ndarray,
                          points: np.ndarray) -> np.ndarray:
        """Boolean mask of points inside the frustum (projection.py:122-155)."""
        p1 = points - corners[2, :3]
        p2 = points - corners[4, :3]
        mask = np.ones(len(points), bool)
        for k in range(6):
            ref = p1 if k < 3 else p2
            dot = np.round(ref @ normals[k] * 100) / 100
            mask &= dot < 0
        return mask

    def compute_projection(self, points: np.ndarray, depth: np.ndarray,
                           camera_to_world: np.ndarray
                           ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Point→pixel correspondence for one frame (projection.py:191-258).

        Returns (indices_3d, indices_2d), both length num_points+1 with the
        valid count in slot 0 — the reference's fixed-size encoding."""
        num_points = len(points)
        world_to_camera = np.linalg.inv(camera_to_world)

        corners = self.compute_frustum_corners(camera_to_world)
        normals = self.compute_frustum_normals(corners)
        mask = self.points_in_frustum(corners, normals, points)
        if not mask.any():
            return None
        ind_points = np.where(mask)[0]
        coords = np.ones((4, len(ind_points)))
        coords[:3] = points[ind_points].T

        camera = world_to_camera @ coords
        u = (camera[0] * self.intrinsic[0][0]) / camera[2] + self.intrinsic[0][2]
        v = (camera[1] * self.intrinsic[1][1]) / camera[2] + self.intrinsic[1][2]
        iu = np.round(u).astype(np.int64)
        iv = np.round(v).astype(np.int64)

        w, h = self.image_dims
        valid = (iu >= 0) & (iv >= 0) & (iu < w) & (iv < h)
        if not valid.any():
            return None
        pix = iv[valid] * w + iu[valid]

        depth_vals = depth.reshape(-1)[pix]
        z = camera[2][valid]
        dmask = ((depth_vals >= self.depth_min)
                 & (depth_vals <= self.depth_max)
                 & (np.abs(depth_vals - z) <= self.accuracy))
        if not dmask.any():
            return None

        ind_update = ind_points[valid][dmask]
        indices_3d = np.zeros(num_points + 1, np.int64)
        indices_2d = np.zeros(num_points + 1, np.int64)
        n = len(ind_update)
        indices_3d[0] = n
        indices_2d[0] = n
        indices_3d[1:1 + n] = ind_update
        indices_2d[1:1 + n] = pix[dmask]
        return indices_3d, indices_2d

    @staticmethod
    def project(features: np.ndarray, indices_3d: np.ndarray,
                indices_2d: np.ndarray, num_points: int) -> np.ndarray:
        """Scatter 2D features (C, H, W) or (H, W) onto points -> (C, num_points)."""
        feats = features if features.ndim == 3 else features[None]
        C = feats.shape[0]
        out = np.zeros((C, num_points), feats.dtype)
        n = int(indices_3d[0])
        if n > 0:
            flat = feats.reshape(C, -1)
            out[:, indices_3d[1:1 + n]] = flat[:, indices_2d[1:1 + n]]
        return out


# ScanNet multiview defaults (scripts/project_multiview_features.py)
SCANNET_INTRINSICS = np.array([
    [37.01983, 0, 20, 0],
    [0, 38.52470, 15.5, 0],
    [0, 0, 1, 0],
    [0, 0, 0, 1],
])
PROJECTOR_IMAGE_DIMS = (41, 32)   # ENet trunk output grid for 328x256 frames
DEPTH_MIN, DEPTH_MAX = 0.1, 4.0
PROJECTION_ACCURACY = 0.05
