"""Point-cloud helpers (numpy, host side; a copy of
``scan2cap_tpu/utils/pc_utils.py``): sampling, rotations, mesh normals and
wireframe box PLYs."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from scan2cap_torch.utils.ply import write_ply


def random_sampling(pc: np.ndarray, num_sample: int, replace: Optional[bool] = None,
                    return_choices: bool = False,
                    rs: Optional[np.random.RandomState] = None):
    """Down/over-sample to a fixed budget (utils/pc_utils.py:32-40):
    without replacement when enough points, else with replacement."""
    rng = rs if rs is not None else np.random
    if replace is None:
        replace = pc.shape[0] < num_sample
    choices = rng.choice(pc.shape[0], num_sample, replace=replace)
    if return_choices:
        return pc[choices], choices
    return pc[choices]


def rotx(t: float) -> np.ndarray:
    c, s = np.cos(t), np.sin(t)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], dtype=np.float64)


def roty(t: float) -> np.ndarray:
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=np.float64)


def rotz(t: float) -> np.ndarray:
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], dtype=np.float64)


def compute_normals(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted per-vertex normals from a triangle mesh (replacement for
    scannet_utils.compute_normal)."""
    normals = np.zeros_like(vertices, dtype=np.float64)
    tris = vertices[faces]
    fn = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    for i in range(3):
        np.add.at(normals, faces[:, i], fn)
    norm = np.linalg.norm(normals, axis=1, keepdims=True)
    return (normals / np.maximum(norm, 1e-12)).astype(np.float32)


# the 12 edges of a box's 8 corners
BOX_EDGES = [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7), (7, 4),
             (0, 4), (1, 5), (2, 6), (3, 7)]


def write_bbox_ply(path: str, corners: np.ndarray,
                   color: Tuple[int, int, int] = (0, 255, 0)) -> None:
    """Write boxes ((..., 8, 3) corners) as a coloured PLY of 16 points on
    each edge (replaces the trimesh-based writer in utils/pc_utils.py)."""
    pts = []
    for box in corners.reshape(-1, 8, 3):
        for a, b in BOX_EDGES:
            pts.append(np.linspace(box[a], box[b], 16))
    pts = np.concatenate(pts, axis=0).astype(np.float32)
    rgb = np.tile(np.asarray(color, np.uint8), (len(pts), 1))
    write_ply(path, pts, rgb)
