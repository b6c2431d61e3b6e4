"""Furthest-point sampling + point gathering
(counterpart of ``scan2cap_tpu/ops/sampling.py:46-110``).

``furthest_point_sample`` keeps the reference CUDA semantics
(sampling_gpu.cu:69-173): seed index 0; points with |p|^2 <= 1e-3 are never
selected; each step takes the argmax of the running min squared distance,
ties to the lowest index; int32 (B, npoint) output; no gradient.

It runs as the custom op ``scan2cap::furthest_point_sample``
(``ops/library.py``): a CUDA tensor goes to the hand-written kernel
(``kernels/fps.py``), a CPU tensor to the plain version below.
"""

from __future__ import annotations

import torch

# looked up here at each call by the op's CUDA implementation
from scan2cap_torch.kernels.fps import furthest_point_sample_cuda  # noqa: F401
from scan2cap_torch.ops.distance import sq_dist_reduce


def furthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """(B, N, 3) -> (B, npoint) int32 indices into N."""
    return torch.ops.scan2cap.furthest_point_sample(xyz.detach(), npoint)


def furthest_point_sample_plain(xyz: torch.Tensor, npoint: int, *,
                                take=None) -> torch.Tensor:
    """Plain PyTorch FPS: the loop of ``scan2cap_tpu/ops/sampling.py:69-96``.

    Works on any device; the CPU path of ``furthest_point_sample`` and the
    yardstick the kernel is held against on the card.  ``take(j, min_d2,
    argmax) -> (B,)`` picks step j instead of the argmax, from the running
    min distances: the tie proof (``probes/ties.py``) follows another
    run's picks with it."""
    if xyz.dim() != 3 or xyz.shape[-1] != 3:
        raise ValueError(f"xyz must be (B, N, 3), got {tuple(xyz.shape)}")
    B, N, _ = xyz.shape
    x = xyz.detach().to(torch.float32)
    px, py, pz = x[..., 0], x[..., 1], x[..., 2]
    valid = sq_dist_reduce(px, py, pz) > 1e-3
    # invalid points start at -1: min(-1, d2 >= 0) stays -1, so they never win
    min_d2 = torch.where(valid, torch.full_like(px, 1e10),
                         torch.full_like(px, -1.0))
    idxs = torch.zeros((B, npoint), dtype=torch.int64, device=x.device)
    rows = torch.arange(B, device=x.device)
    last = torch.zeros((B,), dtype=torch.int64, device=x.device)
    for j in range(1, npoint):
        lp = x[rows, last]                                   # (B, 3)
        dx = px - lp[:, 0:1]
        dy = py - lp[:, 1:2]
        dz = pz - lp[:, 2:3]
        d2 = sq_dist_reduce(dx, dy, dz)       # jnp.sum((x - last)**2, -1)
        min_d2 = torch.minimum(min_d2, d2)
        last = torch.argmax(min_d2, dim=-1)                  # first max wins
        if take is not None:
            last = take(j, min_d2, last)
        idxs[:, j] = last
    return idxs.to(torch.int32)


def gather_points(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """features (B, N, C), idx (B, M) -> (B, M, C)."""
    idx = idx.long()
    return torch.gather(
        features, 1, idx[..., None].expand(-1, -1, features.shape[-1]))
