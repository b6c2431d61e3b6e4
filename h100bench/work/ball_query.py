"""The first-k ball query's work from a call's inputs: a query tests
points in index order up to its nsample-th hit, or all N where it has
fewer hits; each test is 9 operations (3 differences, 2 fused
multiply-adds and a product, the compare, the count).  A scene's points
are read up to the furthest any of its queries tests, its queries read
and its lists written once.  The hits come from a plain ball query of
the reference's rounding, never from the kernel's outputs."""

from __future__ import annotations

import torch

from h100bench.reference.ops import hits
from h100bench.work import bound_s

OPS_PER_PAIR = 9
KERNELS = ("bq_kernel", "bq_ordered_kernel")
_CHUNK = 512


@torch.no_grad()
def tested(xyz: torch.Tensor, new_xyz: torch.Tensor, r2: float,
           nsample: int) -> torch.Tensor:
    """(B, M) int64: the points each query tests."""
    B, N, _ = xyz.shape
    M = new_xyz.shape[1]
    out = torch.empty((B, M), dtype=torch.int64, device=xyz.device)
    for b in range(B):
        for s in range(0, M, _CHUNK):
            hit = hits(xyz[b].float(), new_xyz[b, s:s + _CHUNK].float(), r2)
            count = torch.cumsum(hit, dim=1, dtype=torch.int32)
            # the nsample-th hit's index + 1 is the number of points with
            # fewer than nsample hits at or before them, plus one
            upto = (count < nsample).sum(dim=1) + 1
            out[b, s:s + _CHUNK] = torch.where(count[:, -1] >= nsample, upto,
                                               torch.full_like(upto, N))
    return out


def call_bound_s(xyz, new_xyz, r2: float, nsample: int) -> float:
    B, M = new_xyz.shape[:2]
    t = tested(xyz, new_xyz, r2, nsample)
    pairs, points = int(t.sum()), int(t.amax(dim=1).sum())
    return bound_s(points * 12 + B * M * 12 + B * M * nsample * 4,
                   pairs * OPS_PER_PAIR)


def sites_bound_s(sites) -> float:
    return sum(call_bound_s(*call) for call in sites.first_k)
