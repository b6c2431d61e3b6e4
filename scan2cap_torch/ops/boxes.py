"""Axis-aligned 3D box geometry
(counterpart of ``scan2cap_tpu/ops/boxes.py:31,66,81,98``)."""

from __future__ import annotations

from typing import Tuple

import torch

from scan2cap_torch.config import SCANNET_MEAN_SIZE_ARR
from scan2cap_torch.ops.distance import fma32

_SX = (1, 1, -1, -1, 1, 1, -1, -1)
_SY = (1, -1, -1, 1, 1, -1, -1, 1)
_SZ = (1, 1, 1, 1, -1, -1, -1, -1)


def roty_batch(angle: torch.Tensor) -> torch.Tensor:
    """Rotation about the y-axis (box_util.py:326-338). (...,) -> (..., 3, 3)."""
    c, s = torch.cos(angle), torch.sin(angle)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([
        torch.stack([c, z, s], dim=-1),
        torch.stack([z, o, z], dim=-1),
        torch.stack([-s, z, c], dim=-1),
    ], dim=-2)


def get_3d_box_batch(box_size: torch.Tensor, heading_angle: torch.Tensor,
                     center: torch.Tensor) -> torch.Tensor:
    """Corners (box_util.py:360-382): box_size (..., 3), heading (...,),
    center (..., 3) -> (..., 8, 3), in the reference's corner order."""
    l = box_size[..., 0:1]
    w = box_size[..., 1:2]
    h = box_size[..., 2:3]
    kw = dict(dtype=box_size.dtype, device=box_size.device)
    sx, sy, sz = (torch.tensor(v, **kw) for v in (_SX, _SY, _SZ))
    corners = torch.stack([l / 2 * sx, w / 2 * sy, h / 2 * sz], dim=-1)
    R = roty_batch(heading_angle)
    corners = torch.einsum("...ij,...kj->...ki", R, corners)
    return corners + center[..., None, :]


def box_min_max(corners: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., 8, 3) -> min (..., 3), max (..., 3)."""
    return corners.amin(dim=-2), corners.amax(dim=-2)


def box3d_iou_batch(corners1: torch.Tensor,
                    corners2: torch.Tensor) -> torch.Tensor:
    """Elementwise AABB IoU over broadcast leading dims (box_util.py:156-209):
    (..., 8, 3) x (..., 8, 3) -> (...,).

    Rounded as jitted XLA rounds the JAX function on the CPU: each product
    of extents is ``(x*y)*z``, and the union's ``vol1 + vol2`` is one fused
    multiply-add onto ``vol2`` (``fma32``); ``- inter`` and ``+ 1e-8``
    follow.  The IoU gates decisions (the caption keep gate, the target
    argmax, the local-context overlay), so it must equal JAX's bit for bit."""
    min1, max1 = box_min_max(corners1)
    min2, max2 = box_min_max(corners2)
    lo = torch.maximum(min1, min2)
    hi = torch.minimum(max1, max2)
    e = torch.clamp(hi - lo, min=0.0)
    inter = (e[..., 0] * e[..., 1]) * e[..., 2]
    s1, s2 = max1 - min1, max2 - min2
    vol2 = (s2[..., 0] * s2[..., 1]) * s2[..., 2]
    s1x, s1y, s1z, vol2 = torch.broadcast_tensors(s1[..., 0], s1[..., 1],
                                                  s1[..., 2], vol2)
    union = fma32(s1x * s1y, s1z, vol2)
    return inter / (union - inter + 1e-8)


def box3d_iou_matrix(corners1: torch.Tensor,
                     corners2: torch.Tensor) -> torch.Tensor:
    """All-pairs AABB IoU over leading batch dims:
    (..., N, 8, 3) x (..., M, 8, 3) -> (..., N, M)."""
    min1, max1 = box_min_max(corners1)
    min2, max2 = box_min_max(corners2)
    lo = torch.maximum(min1[..., :, None, :], min2[..., None, :, :])
    hi = torch.minimum(max1[..., :, None, :], max2[..., None, :, :])
    inter = torch.prod(torch.clamp(hi - lo, min=0.0), dim=-1)
    vol1 = torch.prod(max1 - min1, dim=-1)
    vol2 = torch.prod(max2 - min2, dim=-1)
    return inter / (vol1[..., :, None] + vol2[..., None, :] - inter + 1e-8)


def param2obb_batch(center: torch.Tensor, heading_class: torch.Tensor,
                    heading_residual: torch.Tensor, size_class: torch.Tensor,
                    size_residual: torch.Tensor) -> torch.Tensor:
    """Oriented-box decode (model_util_scannet.py:166-172): (..., 7) as
    center, size, -heading.  ScanNet's heading is always 0 (class2angle
    returns 0), so the heading inputs only fix the shape."""
    mean = torch.as_tensor(SCANNET_MEAN_SIZE_ARR, device=center.device)
    size = mean[size_class.long()] + size_residual
    heading = torch.zeros(center.shape[:-1], dtype=center.dtype,
                          device=center.device)
    return torch.cat([center, size, (-heading)[..., None]], dim=-1)
