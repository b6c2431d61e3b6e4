"""Binary PLY writing (a copy of ``write_ply`` of
``scan2cap_tpu/utils/ply.py``): points, optional uint8 colours and triangle
faces, little-endian."""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np


def write_ply(path: str, xyz: np.ndarray, rgb: Optional[np.ndarray] = None,
              faces: Optional[np.ndarray] = None) -> None:
    """Write points (+optional uint8 colors, triangle faces) as binary PLY."""
    n = len(xyz)
    with open(path, "wb") as f:
        header = ["ply", "format binary_little_endian 1.0",
                  f"element vertex {n}",
                  "property float x", "property float y", "property float z"]
        if rgb is not None:
            header += ["property uchar red", "property uchar green",
                       "property uchar blue"]
        if faces is not None:
            header += [f"element face {len(faces)}",
                       "property list uchar int vertex_indices"]
        header.append("end_header")
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if rgb is None:
            f.write(xyz.astype("<f4").tobytes())
        else:
            dt = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                           ("r", "u1"), ("g", "u1"), ("b", "u1")])
            arr = np.empty(n, dt)
            arr["x"], arr["y"], arr["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
            arr["r"], arr["g"], arr["b"] = rgb[:, 0], rgb[:, 1], rgb[:, 2]
            f.write(arr.tobytes())
        if faces is not None:
            for face in faces:
                f.write(struct.pack("<B3i", 3, *[int(v) for v in face]))
