"""Ball query + grouping (counterpart of ``scan2cap_tpu/ops/grouping.py``).

``ball_query`` keeps the reference CUDA semantics (ball_query_gpu.cu:9-54):
for each query the N points are scanned in index order and the first
``nsample`` with squared distance strictly below radius^2 are kept; the
slots past the hit count repeat the first hit; a query with no hit returns
all zeros.  Distances are the f32 coordinate-difference form with the JAX
op's FMA rounding (``ops/distance.py``), and radius^2 is the host's double
``radius ** 2`` rounded once to f32 — the value the JAX op compares
against.

``group_points`` is the row gather ``out[b, m, s] = features[b, idx[b, m, s]]``
with its gradient, a scatter-add into the table (``index_add_``; on CUDA
that sums with atomics in no fixed order, so the gradient is not
bit-stable between runs).

Both run as custom ops, ``scan2cap::ball_query`` and
``scan2cap::group_points`` (``ops/library.py``): a CUDA tensor goes to the
hand-written kernels (``kernels/ballquery.py``, ``kernels/gather.py``), a
CPU tensor to the plain versions below.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

# looked up here at each call by the ops' CUDA implementations
from scan2cap_torch.kernels.ballquery import ball_query_cuda  # noqa: F401
from scan2cap_torch.kernels.gather import group_points_cuda  # noqa: F401
from scan2cap_torch.ops.distance import sq_dist_elementwise

# queries per hit-test slab in the plain versions: a (512, N) bool slab
_CHUNK = 512


def radius_squared(radius: float) -> float:
    """radius**2 in double, rounded to f32 (exact as a Python float)."""
    return float(np.float32(float(radius) ** 2))


def _hits(xyz: torch.Tensor, new_xyz: torch.Tensor, r2: float) -> torch.Tensor:
    """(N, 3), (m, 3) -> (m, N) bool, d2 < r2 in the difference form."""
    dx = new_xyz[:, None, 0] - xyz[None, :, 0]
    dy = new_xyz[:, None, 1] - xyz[None, :, 1]
    dz = new_xyz[:, None, 2] - xyz[None, :, 2]
    return sq_dist_elementwise(dx, dy, dz) < r2


def _first_k(hit: torch.Tensor, nsample: int) -> torch.Tensor:
    """(m, N) bool -> (m, nsample) int32 first-k hit columns, padded with
    the first hit, all zeros where a row has no hit."""
    m, N = hit.shape
    rank = torch.cumsum(hit, dim=1, dtype=torch.int32) - 1
    keep = hit & (rank < nsample)
    rows, cols = torch.nonzero(keep, as_tuple=True)
    out = torch.zeros((m, nsample), dtype=torch.int64, device=hit.device)
    out[rows, rank[rows, cols].long()] = cols
    total = torch.clamp(hit.sum(dim=1), max=nsample)               # (m,)
    slot = torch.arange(nsample, device=hit.device)
    out = torch.where(slot[None, :] < total[:, None], out, out[:, :1])
    return out.to(torch.int32)


def ball_query_plain(xyz: torch.Tensor, new_xyz: torch.Tensor, radius: float,
                     nsample: int) -> torch.Tensor:
    """Plain PyTorch ball query: chunked difference-form hit test, then a
    first-k by running hit rank.  (B, N, 3), (B, M, 3) -> (B, M, nsample)."""
    r2 = radius_squared(radius)
    xyz = xyz.detach().to(torch.float32)
    new_xyz = new_xyz.detach().to(torch.float32)
    B, M, _ = new_xyz.shape
    out = torch.empty((B, M, nsample), dtype=torch.int32, device=xyz.device)
    for b in range(B):
        for s in range(0, M, _CHUNK):
            out[b, s:s + _CHUNK] = _first_k(
                _hits(xyz[b], new_xyz[b, s:s + _CHUNK], r2), nsample)
    return out


def ball_query_pack_plain(xyz: torch.Tensor, new_xyz: torch.Tensor,
                          r2: float):
    """Plain PyTorch version of the pack contract: words (B, M, W) uint32
    hit bitmasks (bit i of word w = point 32w+i), counts (B, M, W) int32
    per-word popcounts, W = ceil(N/32).  ``r2`` as from ``radius_squared``."""
    xyz = xyz.detach().to(torch.float32)
    new_xyz = new_xyz.detach().to(torch.float32)
    B, N, _ = xyz.shape
    M = new_xyz.shape[1]
    W = -(-N // 32)
    weights = torch.pow(2, torch.arange(32, device=xyz.device,
                                        dtype=torch.int64))
    words = torch.empty((B, M, W), dtype=torch.int64, device=xyz.device)
    counts = torch.empty((B, M, W), dtype=torch.int32, device=xyz.device)
    for b in range(B):
        for s in range(0, M, _CHUNK):
            hit = _hits(xyz[b], new_xyz[b, s:s + _CHUNK], r2)
            hit = torch.nn.functional.pad(hit, (0, W * 32 - N))
            bits = hit.reshape(hit.shape[0], W, 32)
            words[b, s:s + _CHUNK] = (bits.long() * weights).sum(-1)
            counts[b, s:s + _CHUNK] = bits.sum(-1, dtype=torch.int32)
    return words.to(torch.uint32), counts


def ball_query(xyz: torch.Tensor, new_xyz: torch.Tensor, radius: float,
               nsample: int) -> torch.Tensor:
    """(B, N, 3) points, (B, M, 3) queries -> (B, M, nsample) int32."""
    # no cast: the kernel takes float32 alone and refuses the rest
    return torch.ops.scan2cap.ball_query(xyz.detach(), new_xyz.detach(),
                                         float(radius), int(nsample))


def group_points_plain(features: torch.Tensor, idx: torch.Tensor
                       ) -> torch.Tensor:
    """Plain PyTorch row gather: features (B, N, C), idx (B, M, S) ->
    (B, M, S, C).  The CPU path of ``group_points`` and the yardstick the
    kernel is held against on the card."""
    B, N, C = features.shape
    _, M, S = idx.shape
    flat = idx.reshape(B, M * S).long()
    out = torch.gather(features, 1, flat[..., None].expand(-1, -1, C))
    return out.reshape(B, M, S, C)


def group_points_forward(features: torch.Tensor, idx: torch.Tensor
                         ) -> torch.Tensor:
    """The gather without a gradient: the kernel on a CUDA tensor, the
    plain version on a CPU tensor."""
    return torch.ops.scan2cap.group_points(features.detach(), idx)


def group_points(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """features (B, N, C), idx (B, M, S) -> (B, M, S, C), differentiable in
    ``features`` (the op's ``register_autograd``).  Indices must lie in
    [0, N)."""
    return torch.ops.scan2cap.group_points(features, idx)


def query_and_group(xyz: torch.Tensor, new_xyz: torch.Tensor,
                    features: Optional[torch.Tensor], radius: float,
                    nsample: int, use_xyz: bool = True,
                    normalize_xyz: bool = False,
                    ret_grouped_xyz: bool = False):
    """Ball query + recentred grouping (pointnet2_utils.py:294-377),
    channels-last: (B, M, S, 3+C) [or (B, M, S, C)]."""
    idx = ball_query(xyz, new_xyz, radius, nsample)
    grouped_xyz = group_points(xyz, idx) - new_xyz[:, :, None, :]
    if normalize_xyz:
        grouped_xyz = grouped_xyz / radius
    if features is not None:
        grouped_features = group_points(features, idx)
        new_features = (torch.cat([grouped_xyz, grouped_features], dim=-1)
                        if use_xyz else grouped_features)
    else:
        if not use_xyz:
            raise ValueError("cannot have no features and use_xyz=False")
        new_features = grouped_xyz
    if ret_grouped_xyz:
        return new_features, grouped_xyz
    return new_features


def group_all(xyz: torch.Tensor, features: Optional[torch.Tensor],
              use_xyz: bool = True) -> torch.Tensor:
    """One group over the whole cloud: (B, 1, N, 3+C) [or (B, 1, N, C)],
    absolute coordinates."""
    grouped_xyz = xyz[:, None]
    if features is not None:
        grouped_features = features[:, None]
        if use_xyz:
            return torch.cat([grouped_xyz, grouped_features], dim=-1)
        return grouped_features
    if not use_xyz:
        raise ValueError("cannot have no features and use_xyz=False")
    return grouped_xyz
