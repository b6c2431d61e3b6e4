"""PLY reading and writing (a copy of ``scan2cap_tpu/utils/ply.py``).

``read_ply`` reads ascii and binary little-endian files with vertex
properties and list-valued face elements; ``write_ply`` writes points,
optional uint8 colours and triangle faces as binary little-endian."""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def read_ply(path: str) -> Dict[str, np.ndarray]:
    """Read a PLY file -> {"vertex": structured array, "face": (F,3) int array}."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError("not a PLY file")
        fmt = None
        elements: List[Tuple[str, int, List[Tuple[str, str]]]] = []
        cur_props: List[Tuple[str, str]] = []
        cur_name, cur_count = None, 0
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("comment"):
                continue
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                if cur_name is not None:
                    elements.append((cur_name, cur_count, cur_props))
                _, cur_name, n = line.split()
                cur_count, cur_props = int(n), []
            elif line.startswith("property"):
                parts = line.split()
                if parts[1] == "list":
                    cur_props.append((parts[-1], f"list:{parts[2]}:{parts[3]}"))
                else:
                    cur_props.append((parts[-1], parts[1]))
            elif line == "end_header":
                if cur_name is not None:
                    elements.append((cur_name, cur_count, cur_props))
                break

        out: Dict[str, np.ndarray] = {}
        for name, count, props in elements:
            if any(t.startswith("list:") for _, t in props):
                # face element: assume one list property of uchar count
                faces = []
                if fmt == "ascii":
                    for _ in range(count):
                        vals = f.readline().split()
                        n = int(vals[0])
                        faces.append([int(v) for v in vals[1:1 + n]])
                else:
                    _, t = props[0]
                    _, cnt_t, idx_t = t.split(":")
                    cnt_dt = np.dtype(_DTYPES[cnt_t])
                    idx_dt = np.dtype("<" + _DTYPES[idx_t])
                    for _ in range(count):
                        n = int(np.frombuffer(f.read(cnt_dt.itemsize), cnt_dt)[0])
                        faces.append(np.frombuffer(
                            f.read(idx_dt.itemsize * n), idx_dt).tolist())
                out[name] = np.asarray(faces)
            else:
                dtype = np.dtype([(p, "<" + _DTYPES[t]) for p, t in props])
                if fmt == "ascii":
                    rows = [tuple(f.readline().split()[:len(props)])
                            for _ in range(count)]
                    out[name] = np.array(
                        [tuple(np.dtype(dtype[i]).type(v)
                               for i, v in enumerate(r)) for r in rows],
                        dtype=dtype)
                else:
                    out[name] = np.frombuffer(
                        f.read(dtype.itemsize * count), dtype).copy()
        return out


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
