"""3D box geometry (counterpart of ``scan2cap_tpu/ops/boxes.py``):
corners, the axis-aligned IoU, the generalized IoU of axis-aligned and
of z-rotated boxes that the offline benchmark assigns by, and the
batched axis-aligned generalized IoU that Vote2Cap-DETR matches by."""

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


def _generalized_iou_bounds(min1, max1, min2, max2):
    """All-pairs generalized IoU of axis-aligned boxes from their corners
    of least and greatest coordinates, (..., N, 3) twice and (..., M, 3)
    twice -> (..., N, M)."""
    lo = torch.maximum(min1[..., :, None, :], min2[..., None, :, :])
    hi = torch.minimum(max1[..., :, None, :], max2[..., None, :, :])
    inter = torch.prod(torch.clamp(hi - lo, min=0.0), dim=-1)
    vol1 = torch.prod(max1 - min1, dim=-1)
    vol2 = torch.prod(max2 - min2, dim=-1)
    union = vol1[..., :, None] + vol2[..., None, :] - inter
    iou = inter / (union + 1e-8)
    enc_lo = torch.minimum(min1[..., :, None, :], min2[..., None, :, :])
    enc_hi = torch.maximum(max1[..., :, None, :], max2[..., None, :, :])
    enc = torch.prod(torch.clamp(enc_hi - enc_lo, min=0.0), dim=-1)
    return iou - (enc - union) / (enc + 1e-8)


def generalized_box3d_iou_aabb(corners1: torch.Tensor,
                               corners2: torch.Tensor) -> torch.Tensor:
    """All-pairs generalized IoU of axis-aligned boxes
    (``scan2cap_tpu/ops/boxes.py:111-133``; benchmark/box_util.py:634-696,
    rotated_boxes=False): IoU - (vol(enclosing) - vol(union)) /
    vol(enclosing).  corners1 (N, 8, 3), corners2 (M, 8, 3) -> (N, M)."""
    return _generalized_iou_bounds(*box_min_max(corners1),
                                   *box_min_max(corners2))


def generalized_iou_aabb(center1: torch.Tensor, size1: torch.Tensor,
                         center2: torch.Tensor, size2: torch.Tensor
                         ) -> torch.Tensor:
    """The same of boxes given by centre and size over shared leading
    dims, (..., N, 3) twice and (..., M, 3) twice -> (..., N, M): what
    Vote2Cap-DETR's matcher costs (3DETR's ``generalized_box3d_iou``,
    axis-aligned)."""
    return _generalized_iou_bounds(center1 - size1 / 2, center1 + size1 / 2,
                                   center2 - size2 / 2, center2 + size2 / 2)


def _clip_convex(verts: torch.Tensor, valid: torch.Tensor,
                 clip: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sutherland-Hodgman: clip padded polygons by a convex 4-gon
    (``scan2cap_tpu/ops/boxes.py:136-188``).

    verts (..., V, 2) cyclically filled polygons (an invalid slot repeats
    the previous vertex, so its edge is degenerate), valid (..., V) bool,
    clip (..., 4, 2) counter-clockwise.  Returns the (..., 16V, 2) padded
    polygon and its validity after the four clip edges.  The emission order
    per clip edge and the strict inside test are the reference clipper's
    (benchmark/box_util.py:456-509): for each subject edge s->e, the
    intersection when the edge crosses the clip line, then e when inside."""
    V = verts.shape[-2]
    for k in range(4):
        cp1 = clip[..., k - 1, :]          # k - 1 wraps: the edge cp1 -> cp2
        cp2 = clip[..., k, :]
        d = cp2 - cp1                                       # (..., 2)

        def inside(p):                     # p (..., V, 2)
            return (d[..., None, 0] * (p[..., 1] - cp1[..., None, 1])
                    > d[..., None, 1] * (p[..., 0] - cp1[..., None, 0]))

        e = verts
        s = torch.roll(verts, 1, dims=-2)
        in_e, in_s = inside(e), inside(s)
        # line-line intersection (helper_computeIntersection's algebra)
        n1 = (cp1[..., 0] * cp2[..., 1] - cp1[..., 1] * cp2[..., 0])[..., None]
        n2 = s[..., 0] * e[..., 1] - s[..., 1] * e[..., 0]
        dp = s - e
        den = (-d[..., None, 0]) * dp[..., 1] - (-d[..., None, 1]) * dp[..., 0]
        den = torch.where(torch.abs(den) > 0, den, torch.ones_like(den))
        ix = (n1 * dp[..., 0] - n2 * (-d[..., None, 0])) / den
        iy = (n1 * dp[..., 1] - n2 * (-d[..., None, 1])) / den
        inter = torch.stack([ix, iy], dim=-1)               # (..., V, 2)

        out = torch.stack([inter, e], dim=-2).reshape(
            verts.shape[:-2] + (2 * V, 2))
        ok = torch.stack([(in_e ^ in_s) & valid, in_e & valid],
                         dim=-1).reshape(valid.shape[:-1] + (2 * V,))

        # cyclic forward fill: an invalid slot repeats the previous valid
        # vertex (the second pass wraps the leading slots to the last one)
        prev = torch.zeros_like(out[..., 0, :])
        for _ in range(2):
            filled = []
            for i in range(2 * V):
                prev = torch.where(ok[..., i, None], out[..., i, :], prev)
                filled.append(prev)
            out = torch.stack(filled, dim=-2)
        verts, valid, V = out, ok, 2 * V
    return verts, valid


def generalized_box3d_iou_rotated(corners1: torch.Tensor,
                                  corners2: torch.Tensor) -> torch.Tensor:
    """All-pairs generalized IoU of z-rotated boxes
    (``scan2cap_tpu/ops/boxes.py:191-261``; the reference's
    rotated_boxes=True path, benchmark/box_util.py:586-696), every pair at
    once on the tensors' device: the footprints (corners 3, 2, 1, 0, columns
    x and y) clipped against each other, the z overlap from corners 0 and 4,
    volumes from edge lengths, the axis-aligned enclosing volume, pairs
    whose axis-aligned footprints do not touch at intersection 0, the
    good-box gate, and gIoU = IoU - (1 - union / enclosing).
    corners1 (N, 8, 3), corners2 (M, 8, 3) -> (N, M) float32."""
    EPS = 1e-8
    c1 = corners1.to(torch.float32)
    c2 = corners2.to(torch.float32)

    zmax = torch.minimum(c1[:, 0, 2][:, None], c2[:, 0, 2][None, :])
    zmin = torch.maximum(c1[:, 4, 2][:, None], c2[:, 4, 2][None, :])
    height = torch.clamp(zmax - zmin, min=0.0)

    order = [3, 2, 1, 0]
    rect1 = c1[:, order, :2]                              # (N, 4, 2) ccw
    rect2 = c2[:, order, :2]

    # the axis-aligned footprint overlap gate (non_rot_inter_areas)
    lt = torch.maximum(rect1[:, None, 1, :], rect2[None, :, 1, :])
    rb = torch.minimum(rect1[:, None, 3, :], rect2[None, :, 3, :])
    wh = torch.clamp(rb - lt, min=0.0)
    gate = wh[..., 0] * wh[..., 1] > 0                    # (N, M)

    N, M = rect1.shape[0], rect2.shape[0]
    subject = rect1[:, None].expand(N, M, 4, 2)
    clip = rect2[None, :].expand(N, M, 4, 2)
    valid = torch.ones((N, M, 4), dtype=torch.bool, device=c1.device)
    verts, _ = _clip_convex(subject, valid, clip)         # (N, M, 64, 2)

    x, y = verts[..., 0], verts[..., 1]
    inter_area = 0.5 * torch.abs(
        torch.sum(x * torch.roll(y, 1, dims=-1), dim=-1)
        - torch.sum(y * torch.roll(x, 1, dims=-1), dim=-1))
    inter_area = torch.where(gate, inter_area, torch.zeros_like(inter_area))
    inter_vol = inter_area * height

    def edge_vols(c):
        a = torch.sqrt(torch.clamp(
            torch.sum((c[:, 0] - c[:, 1]) ** 2, -1), min=1e-6))
        b = torch.sqrt(torch.clamp(
            torch.sum((c[:, 1] - c[:, 2]) ** 2, -1), min=1e-6))
        h = torch.sqrt(torch.clamp(
            torch.sum((c[:, 0] - c[:, 4]) ** 2, -1), min=1e-6))
        return a * b * h

    vols1 = torch.clamp(edge_vols(c1), min=EPS)
    vols2 = torch.clamp(edge_vols(c2), min=EPS)
    sum_vols = vols1[:, None] + vols2[None, :]

    lo = torch.minimum(c1.amin(1)[:, None], c2.amin(1)[None, :])
    hi = torch.maximum(c1.amax(1)[:, None], c2.amax(1)[None, :])
    enclosing = torch.prod(torch.abs(hi - lo), dim=-1)

    good = (enclosing > 2 * EPS) & (sum_vols > 4 * EPS)
    union = torch.clamp(sum_vols - inter_vol, min=EPS)
    iou = inter_vol / union
    giou = iou - (1.0 - union / enclosing)
    return torch.where(good, giou, torch.zeros_like(giou))
