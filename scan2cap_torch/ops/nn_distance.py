"""Chamfer (nearest-neighbour) distance and huber loss
(counterpart of ``scan2cap_tpu/ops/nn_distance.py:15-52``; reference
utils/nn_distance.py:13-59).

``nn_distance`` uses the difference form ``sum(diff**2, -1)`` and the
lowest index among equal minima, as ``jnp.argmin`` does.  The jitted JAX
function contracts that 3-wide sum into FMAs, and the objectness labels
and the proposal-to-GT assignment are thresholds and argmins of it, so the
values come from ``ops.distance.sq_dist_reduce`` (XLA's rounding); the
gradient comes from the plain sum, whose value is subtracted out again.
"""

from __future__ import annotations

from typing import Tuple

import torch

from scan2cap_torch.ops.distance import sq_dist_reduce


def huber_loss(error: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """0.5 x^2 for |x| <= delta else 0.5 delta^2 + delta (|x| - delta)
    (utils/nn_distance.py:13-30)."""
    abs_error = torch.abs(error)
    quadratic = torch.clamp(abs_error, max=delta)
    linear = abs_error - quadratic
    return 0.5 * quadratic ** 2 + delta * linear


def _sq_dist(diff: torch.Tensor) -> torch.Tensor:
    """sum(diff**2, -1): XLA's value, the plain sum's gradient."""
    plain = torch.sum(diff ** 2, dim=-1)
    if diff.shape[-1] != 3:
        return plain
    with torch.no_grad():
        exact = sq_dist_reduce(diff[..., 0], diff[..., 1], diff[..., 2])
    return exact + (plain - plain.detach())


def nn_distance(pc1: torch.Tensor, pc2: torch.Tensor, l1smooth: bool = False,
                delta: float = 1.0, l1: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """pc1 (B, N, C), pc2 (B, M, C) -> dist1 (B, N), idx1 (B, N) int32,
    dist2 (B, M), idx2 (B, M) int32: per-point min distance to the other
    set and its argmin (squared L2 by default, huber or L1 variants)."""
    diff = pc1[:, :, None, :] - pc2[:, None, :, :]               # (B,N,M,C)
    if l1smooth:
        dist = torch.sum(huber_loss(diff, delta), dim=-1)
    elif l1:
        dist = torch.sum(torch.abs(diff), dim=-1)
    else:
        dist = _sq_dist(diff)
    # torch.min(dim) promises no tie order; argmin of a stable sort would
    # cost more than it is worth: the first minimum is found by comparing
    # with the min value
    dist1, idx1 = _min_first(dist, 2)
    dist2, idx2 = _min_first(dist, 1)
    return dist1, idx1, dist2, idx2


def _min_first(dist: torch.Tensor, dim: int):
    """Min along ``dim`` and the lowest index that attains it."""
    val = torch.amin(dist.detach(), dim=dim, keepdim=True)
    n = dist.shape[dim]
    shape = [1] * dist.dim()
    shape[dim] = n
    pos = torch.arange(n, device=dist.device).reshape(shape)
    idx = torch.where(dist.detach() == val, pos, n).amin(dim=dim)
    picked = torch.gather(dist, dim, idx.unsqueeze(dim)).squeeze(dim)
    return picked, idx.to(torch.int32)
