"""Edge cases the FPS, ball-query and row-gather kernels are held to on the
card, by name, made from a seed with numpy.  ``chip_smoke.py`` and
``tests/test_torch_kernels.py`` run every one of them against the plain
versions; nothing here needs the card.
"""

from __future__ import annotations

import zlib
from typing import Optional, Tuple

import numpy as np
import torch

from scan2cap_torch.kernels import ballquery
from scan2cap_torch.kernels.fps import _BY_SIZE, fps_variant

# MaskVoteNet's vote aggregation (models/mask_votenet.py): one query of
# radius 5 m and 512 samples over the 1,024 votes of each of the launch
# script's 16 scenes, and the (1, 512) rows of width 128 it gathers
MVN_BATCH, MVN_VOTES = 16, 1024
MVN_RADIUS, MVN_NSAMPLE = 5.0, 512

# the cluster variant of the flagship's first layer, forced onto scenes far
# smaller than it, so that most of its blocks hold no point; and the
# streaming variant of the largest scenes, forced onto small ones
_CLUSTER_N = 40000
_STREAMED_N = _BY_SIZE[-2][0] + 1
_FORCED = (("_in_a_cluster", _CLUSTER_N), ("_streamed", _STREAMED_N))

FPS_EDGE_CASES = (
    "padding", "all_invalid", "ties", "ties_in_a_cluster", "batch10",
    "n1", "n1_in_a_cluster", "n5", "n5_in_a_cluster", "n9", "n9_in_a_cluster",
    "n39999", "ties_across_blocks", "padding_30000_of_40000",
    "all_invalid_40000", "batch10_40000",
    "n1_streamed", "n9_streamed", "ties_streamed", "padding_streamed",
    "all_invalid_streamed",
    # scenes above what registers hold: 2,048 picks, as sa1 takes
    "large_n81921", "large_n100000", "large_n200000",
    # MaskVoteNet's vote aggregation: one pick of 1,024 votes, B=16
    "mvn_aggregation",
) + tuple(f"boundary_n{n}" for bound, _ in _BY_SIZE if bound is not None
          for n in (bound - 1, bound, bound + 1))


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

    cluster, base = None, name
    for suffix, n in _FORCED:
        if name.endswith(suffix):
            cluster, base = fps_variant(n), name[:-len(suffix)]
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
    if base.startswith("large_n"):
        return cloud(2, int(base[len("large_n"):])), 2048, cluster
    if base == "mvn_aggregation":
        return cloud(MVN_BATCH, MVN_VOTES), 1, cluster
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
    "mvn_aggregation": (MVN_BATCH, MVN_VOTES, 128, 1, MVN_NSAMPLE, 0),
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


# --- ball query --------------------------------------------------------------
# the range-splitting variant of the large scenes, forced onto 4,096 points:
# ranges of 1,024 points (32 words), chunks of 512
_BQ_SPLIT = (8, 2, 4, 512)
_BQ_SPLIT_N = 4096
_BQ_BOUNDS = tuple(b for b, _ in ballquery._BY_SIZE if b is not None)

BQ_EDGE_CASES = (
    "on_radius", "no_hits", "many_hits",
    "n1", "n31", "n33", "n999", "n39999",
    "m1", "m_ragged", "m_ragged_split",
    "nsample1", "nsample_above_n", "nsample_limit",
    "exactly_nsample_hits", "exactly_nsample_hits_40000",
    "hits_in_last_range", "hits_in_last_range_40000",
    "nsample_th_hit_ends_a_range", "nsample_th_hit_ends_a_range_40000",
    "nsample_th_hit_starts_a_range", "nsample_th_hit_starts_a_range_40000",
    "first_hit_in_later_range", "first_hit_in_later_range_40000",
    "on_radius_at_boundaries", "on_radius_at_boundaries_40000",
    "dense_40000", "batch10_40000",
    "view_off_4_bytes", "view_off_8_bytes", "view_off_12_bytes",
    # hit lists in device memory (nsample above what shared memory holds)
    "nsample257", "nsample512", "nsample1024",
    "nsample257_40000", "nsample512_40000", "nsample1024_40000",
    # MaskVoteNet's aggregation: one query a scene over rooms of 7 to 16 m,
    # so that some scenes fill their 512 slots and others pad short lists
    "mvn_aggregation",
) + tuple(f"boundary_n{n}" for bound in _BQ_BOUNDS
          for n in (bound - 1, bound, bound + 1))

BqCase = Tuple[np.ndarray, np.ndarray, float, int, Optional[int], int]


def bq_range_points(n: int, variant: Optional[int]) -> int:
    """Points of one range of an ``n``-point scene under ``variant`` (the
    wrapper's choice when None)."""
    v = ballquery.bq_variant(n) if variant is None else variant
    return 32 * ballquery.range_words(n, ballquery.VARIANTS[v][2])[1]


def bq_edge_case(name: str) -> BqCase:
    """(xyz (B, N, 3), new_xyz (B, M, 3), radius, nsample, variant, offset)
    of one ball-query case.  ``variant`` None leaves the choice to the
    wrapper; ``offset`` is how many floats past a 16-byte boundary the
    scene tensor must start (``offset_view`` makes such a tensor)."""
    rs = _rs("bq_" + name)

    def f32(a):
        return np.ascontiguousarray(a, dtype=np.float32)

    def lattice(B, N):                   # 0.1 apart: points on the radius
        return f32(np.round(rs.uniform(-1, 1, (B, N, 3)) * 10) / 10)

    def mixed(B, N):                     # a dense core in a sparse room
        x = rs.uniform(-4, 4, (B, N, 3))
        core = rs.rand(B, N) < 0.5
        x[core] = rs.uniform(-1, 1, (int(core.sum()), 3))
        return f32(x)

    def sparse(B, N, M, hits_at):
        """Every query hits exactly the points at ``hits_at``: those lie
        within 0.07 of a centre, the queries within 0.02, all else is metres
        away; radius 0.2."""
        x = f32(rs.uniform(5, 9, (B, N, 3)))
        centre = rs.uniform(-1, 1, (B, 1, 3))
        at = np.asarray(sorted(hits_at))
        x[:, at] = f32(centre + rs.uniform(-0.04, 0.04, (B, len(at), 3)))
        q = f32(centre + rs.uniform(-0.01, 0.01, (B, M, 3)))
        return x, q

    big = name.endswith("_40000")
    base = name[:-len("_40000")] if big else name
    # the constructed cases: the split variant on 4,096 points, or the
    # wrapper's own choice on 40,000
    N = 40000 if big else _BQ_SPLIT_N
    variant = None if big else ballquery.VARIANTS.index(_BQ_SPLIT)
    L = bq_range_points(N, variant)
    ranges = -(-N // L)
    M = 19

    if base == "on_radius":
        p = lattice(2, 1000)
        return p, p[:, :100].copy(), 0.3, 64, None, 0
    if base == "no_hits":
        return (f32(rs.randn(2, 999, 3)), f32(rs.randn(2, 64, 3) + 50.0),
                0.2, 16, None, 0)
    if base == "many_hits":
        return (f32(rs.rand(2, 4500, 3) * 0.1), f32(rs.rand(2, 33, 3) * 0.1),
                0.5, 32, None, 0)
    if base in ("n1", "n31", "n33", "n999", "n39999"):
        n = int(base[1:])
        p = mixed(2, n)
        return p, p[:, :min(n, 40)].copy(), 0.3, 16, None, 0
    if base.startswith("boundary_n"):    # where the variant changes
        n = int(base[len("boundary_n"):])
        p = mixed(2, n)
        return p, p[:, :40].copy(), 0.4, 32, None, 0
    if base == "m1":
        p = mixed(2, 3000)
        return p, p[:, 7:8].copy(), 0.3, 16, None, 0
    if base == "m_ragged":               # no multiple of any tile
        p = mixed(3, 1500)
        return p, p[:, :37].copy(), 0.3, 16, None, 0
    if base == "m_ragged_split":
        p = mixed(3, _BQ_SPLIT_N)
        return p, p[:, :37].copy(), 0.3, 32, variant, 0
    if base == "nsample1":
        p = mixed(2, 1200)
        return p, p[:, :50].copy(), 0.3, 1, None, 0
    if base == "nsample_above_n":
        p = f32(rs.rand(2, 20, 3) * 0.2)
        return p, p[:, :9].copy(), 0.5, 32, None, 0
    if base == "nsample_limit":          # every range holds more than 256
        p = f32(rs.rand(2, _BQ_SPLIT_N, 3) * 0.3)
        return (p, p[:, :21].copy(), 0.5, ballquery.BQ_SHARED_NSAMPLE,
                variant, 0)
    if base in ("nsample257", "nsample512", "nsample1024"):
        # queries in the dense core hold more hits than nsample, the sparse
        # room's fewer: both the cap and the padding
        n = 40000 if big else 999
        p = mixed(2, n)
        return (p, p[:, :8].copy(), 0.5 if big else 2.5,
                int(base[len("nsample"):]), None, 0)
    if base == "exactly_nsample_hits":
        at = rs.choice(N, 16, replace=False)
        return (*sparse(2, N, M, at), 0.2, 16, variant, 0)
    if base == "hits_in_last_range":     # more than nsample, all at the end
        at = (ranges - 1) * L + rs.choice(N - (ranges - 1) * L, 24,
                                          replace=False)
        return (*sparse(2, N, M, at), 0.2, 16, variant, 0)
    if base == "nsample_th_hit_ends_a_range":
        at = list(rs.choice(L - 1, 15, replace=False)) + [
            L - 1, L, L + 1, 2 * L + 3]
        return (*sparse(2, N, M, at), 0.2, 16, variant, 0)
    if base == "nsample_th_hit_starts_a_range":
        at = list(rs.choice(L, 15, replace=False)) + [L, L + 1, 3 * L - 1]
        return (*sparse(2, N, M, at), 0.2, 16, variant, 0)
    if base == "first_hit_in_later_range":   # the padding repeats it
        at = [2 * L + 5, 2 * L + 40, 3 * L, 3 * L + 1, N - 1]
        return (*sparse(2, N, M, at), 0.2, 16, variant, 0)
    if base == "on_radius_at_boundaries":
        # lattice neighbours of query 0 at distance exactly 0.3, on both
        # sides of a chunk's and of a range's end
        p = lattice(2, N)
        q = p[:, :M].copy()
        chunk = ballquery.VARIANTS[
            ballquery.bq_variant(N) if variant is None else variant][3]
        steps = f32([[0.3, 0, 0], [0, 0.3, 0], [0, 0, 0.3], [0.2, 0.2, 0.1],
                     [-0.3, 0, 0], [0.1, -0.2, 0.2], [0, -0.3, 0],
                     [-0.2, 0.1, 0.2]])
        at = [chunk - 1, chunk, L - 1, L, L + chunk - 1, L + chunk, 2 * L - 1,
              2 * L]
        p[:, at] = q[:, :1] + steps[None]
        return p, q, 0.3, 64, variant, 0
    if name == "dense_40000":            # most queries fill their 64 slots
        p = mixed(2, 40000)
        return p, p[:, :133].copy(), 0.2, 64, None, 0
    if name == "batch10_40000":
        p = mixed(10, 40000)
        return p, p[:, :64].copy(), 0.2, 64, None, 0
    if name == "mvn_aggregation":
        half = np.linspace(3.5, 8.0, MVN_BATCH)[:, None, None]
        p = f32(rs.uniform(-1, 1, (MVN_BATCH, MVN_VOTES, 3)) * half
                * np.float32([1, 1, 0.2]))
        return p, p[:, :1].copy(), MVN_RADIUS, MVN_NSAMPLE, None, 0
    if base.startswith("view_off_"):     # N a multiple of 4: only the view
        offset = int(base.split("_")[2]) // 4       # moves the scenes
        p = mixed(2, 1000)
        return p, p[:, :40].copy(), 0.3, 16, None, offset
    raise KeyError(name)


def offset_view(xyz: np.ndarray, offset: int, device="cpu") -> torch.Tensor:
    """``xyz`` as a contiguous tensor on ``device`` whose first element lies
    ``offset`` floats past a 16-byte boundary (a view into a flat buffer)."""
    flat = torch.empty(offset + xyz.size, dtype=torch.float32, device=device)
    view = flat[offset:].view(xyz.shape)
    view.copy_(torch.from_numpy(xyz))
    assert view.is_contiguous() and view.data_ptr() % 16 == 4 * offset
    return view
