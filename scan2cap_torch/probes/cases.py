"""Edge cases the FPS and row-gather kernels are held to on the card, by
name, made from a seed with numpy.  ``chip_smoke.py`` and
``tests/test_torch_kernels.py`` run every one of them against the plain
versions; nothing here needs the card.
"""

from __future__ import annotations

import zlib
from typing import Optional, Tuple

import numpy as np

from scan2cap_torch.kernels.fps import _BY_SIZE, fps_max_points, fps_variant

# the cluster variant of the flagship's first layer, forced onto scenes far
# smaller than it, so that most of its blocks hold no point
_CLUSTER_N = 40000

FPS_EDGE_CASES = (
    "padding", "all_invalid", "ties", "ties_in_a_cluster", "batch10",
    "n1", "n1_in_a_cluster", "n5", "n5_in_a_cluster", "n9", "n9_in_a_cluster",
    "n39999", "ties_across_blocks", "padding_30000_of_40000",
    "all_invalid_40000", "batch10_40000",
) + tuple(f"boundary_n{n}" for bound, _ in _BY_SIZE
          for n in (bound - 1, bound, bound + 1) if n <= fps_max_points())


def _rs(name: str) -> np.random.RandomState:
    return np.random.RandomState(zlib.crc32(name.encode()))


def fps_edge_case(name: str) -> Tuple[np.ndarray, int, Optional[int]]:
    """(xyz (B, N, 3) float32, npoint, variant) of one FPS case; ``variant``
    None leaves the choice to the wrapper."""
    rs = _rs(name)

    def cloud(B, N, shift=0.0):
        return rs.randn(B, N, 3).astype(np.float32) + np.float32(shift)

    def grid(B, N):                                # many equal distances
        return np.round(rs.randn(B, N, 3) * 2.0).astype(np.float32) / 2.0

    cluster = fps_variant(_CLUSTER_N) if name.endswith("_in_a_cluster") else None
    base = name[:-len("_in_a_cluster")] if cluster is not None else name
    if base == "padding":                          # zero padding at the end
        x = cloud(2, 1300, 3.0)
        x[:, 700:] = 0.0
        return x, 64, cluster
    if base == "all_invalid":                      # scene 1 is all padding
        x = cloud(2, 400, 2.0)
        x[1] = 0.0
        return x, 16, cluster
    if base == "ties":                             # duplicates: exact ties
        x = grid(3, 700)
        x[:, 350:] = x[:, :350]
        return x, 48, cluster
    if base == "batch10":
        return cloud(10, 1100), 48, cluster
    if base in ("n1", "n5", "n9"):                 # fewer points than blocks
        return cloud(2, int(base[1:]), 1.0), 12, cluster
    if base == "n39999":                           # no multiple of anything
        return cloud(2, 39999), 96, cluster
    if base == "ties_across_blocks":     # the two copies lie in different blocks
        x = grid(2, 40000)
        x[:, 20000:] = x[:, :20000]
        return x, 256, cluster
    if base == "padding_30000_of_40000":
        x = cloud(2, 40000, 3.0)
        x[:, 10000:] = 0.0
        return x, 128, cluster
    if base == "all_invalid_40000":
        x = cloud(2, 40000, 3.0)
        x[1] = 0.0
        return x, 64, cluster
    if base == "batch10_40000":                    # ten clusters in flight
        return cloud(10, 40000), 64, cluster
    if base.startswith("boundary_n"):              # where the variant changes
        return cloud(2, int(base[len("boundary_n"):])), 32, cluster
    raise KeyError(name)


# name -> (B, N, C, M, S, floats the table's first element lies off a
# 16-byte boundary)
GATHER_EDGE_CASES = {
    "width_1": (2, 3000, 1, 128, 16, 0),
    "width_2": (2, 3000, 2, 128, 16, 0),
    "width_3": (2, 3000, 3, 128, 16, 0),
    "width_5_one_row": (1, 1, 5, 3, 4, 0),
    "width_6": (2, 3000, 6, 128, 16, 0),
    "width_64": (2, 5000, 64, 256, 64, 0),
    "width_130": (2, 3000, 130, 128, 64, 0),
    "width_138": (2, 3000, 138, 128, 64, 0),
    "width_256": (2, 700, 256, 64, 16, 0),
    "width_64_off_4_bytes": (2, 3000, 64, 128, 16, 1),
    "width_64_off_8_bytes": (2, 3000, 64, 128, 16, 2),
    "width_138_off_8_bytes": (2, 3000, 138, 128, 16, 2),
    "width_3_off_4_bytes": (2, 3000, 3, 128, 16, 1),
    "ragged_rows": (2, 900, 64, 37, 7, 0),         # 259 rows: no block's worth
    "ragged_rows_wide": (2, 900, 138, 37, 7, 0),
    "batch10": (10, 700, 256, 64, 16, 0),
}


def gather_edge_case(name: str) -> Tuple[np.ndarray, np.ndarray, int]:
    """(flat float32 buffer, idx (B, M, S) int32, offset): the table is
    ``flat[offset:offset + B*N*C].reshape(B, N, C)``, a contiguous view
    whose first element lies ``offset`` floats into the buffer."""
    B, N, C, M, S, offset = GATHER_EDGE_CASES[name]
    rs = _rs(name)
    idx = rs.randint(0, N, (B, M, S)).astype(np.int32)
    idx[:, :, S // 2:] = idx[:, :, :1]             # repeated indices
    idx[:, 0, 0], idx[:, 0, 1 % S] = 0, N - 1      # first and last row
    flat = rs.randn(offset + B * N * C).astype(np.float32)
    return flat, idx, offset


def gather_table(flat, shape, offset):
    """The (B, N, C) view of a flat buffer (numpy array or tensor) that
    ``gather_edge_case`` describes."""
    B, N, C = shape
    return flat[offset:offset + B * N * C].reshape(B, N, C)
