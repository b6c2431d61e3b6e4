"""Plain point-cloud and box operations of the reference.

A frozen copy of the arithmetic of ``scan2cap_torch.ops``: furthest-point
sampling, the first-k ball query and the row gather as plain loops and
gathers (no kernel), three-NN interpolation, the chamfer distance, box
corners and the axis-aligned IoU.  Squared distances keep the rounding of
the port (one fused multiply-add per term, computed exactly in float64 and
rounded once), since a point on the radius or a tie between two picks is
decided by it.

Every product of the reference goes through ``linear``, ``einsum`` or
``matmul``: plain float32, or under ``precision("tf32")`` with its
operands rounded to nearest at 10 mantissa bits, the tensor cores' TF32
input format, in the forward and the backward alike.  That is the
lower-precision control of the correctness check.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

# ScanNet's 18 per-class mean box sizes in metres
# (meta_data/scannet_reference_means.npz of the reference codebase)
MEAN_SIZE = (
    (0.77504910, 0.94897728, 0.96542059), (1.86903267, 1.83214712, 1.19222992),
    (0.61214778, 0.61928731, 0.70480848), (1.44113898, 1.60452036, 0.83652295),
    (1.04780726, 1.20164188, 0.63457007), (0.56101232, 0.60847217, 1.71950401),
    (1.07894895, 0.82033996, 1.16921199), (0.84171092, 1.35047945, 1.68989250),
    (0.23051737, 0.47640499, 0.56569256), (1.45484899, 1.97119895, 0.28643280),
    (1.07858031, 1.53705113, 0.86501906), (1.43119644, 0.76923111, 1.64982673),
    (0.62969194, 0.70871287, 1.31433587), (0.43925034, 0.41569594, 1.70002748),
    (0.58504462, 0.57878438, 0.72029611), (0.51158693, 0.50960673, 0.31287360),
    (1.17320759, 1.05987140, 0.51812528), (0.43294385, 0.51933507, 0.48437456),
)

_PRECISION = ["float32"]


@contextlib.contextmanager
def precision(name: str):
    """Products of the reference in ``name`` ("float32" or "tf32") while
    open."""
    if name not in ("float32", "tf32"):
        raise ValueError(f"unknown precision {name}")
    _PRECISION.append(name)
    try:
        yield
    finally:
        _PRECISION.pop()


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest value with 10 mantissa bits (ties to even);
    infinities and NaNs as they are."""
    i = x.contiguous().view(torch.int32)
    lsb = torch.bitwise_and(torch.bitwise_right_shift(i, 13), 1)
    r = torch.bitwise_and(i + (0xFFF + lsb), ~0x1FFF)
    finite = torch.isfinite(x)
    return torch.where(finite, r.view(torch.float32), x)


class _TF32Product(torch.autograd.Function):
    """``f(a, b)`` of TF32-rounded operands; its backward's products also
    of rounded operands (the incoming gradient and the saved inputs),
    accumulated in float32, as the tensor cores compute both."""

    @staticmethod
    def forward(ctx, f, a, b):
        ra, rb = round_tf32(a), round_tf32(b)
        ctx.f = f
        ctx.save_for_backward(ra, rb)
        return f(ra, rb)

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        need = ctx.needs_input_grad[1:]
        with torch.enable_grad():
            xa = ra.detach().requires_grad_(need[0])
            xb = rb.detach().requires_grad_(need[1])
            out = ctx.f(xa, xb)
            wrt = [x for x, n in zip((xa, xb), need) if n]
            grads = iter(torch.autograd.grad(out, wrt, round_tf32(g)))
        return (None, *(next(grads) if n else None for n in need))


def _product(f, a, b):
    if _PRECISION[-1] == "float32":
        return f(a, b)
    return _TF32Product.apply(f, a, b)


def linear(x: torch.Tensor, weight: torch.Tensor, bias=None) -> torch.Tensor:
    if _PRECISION[-1] == "float32":
        return torch.nn.functional.linear(x, weight, bias)
    y = _product(torch.nn.functional.linear, x, weight)
    return y if bias is None else y + bias


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _product(lambda x, y: torch.einsum(eq, x, y), a, b)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _product(torch.matmul, a, b)


# ------------------------------------------------------------ distances
def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a*b + c with one rounding: exact in float64, with the
    halfway case settled by the TwoSum error."""
    p = a.double() * b.double()
    c64 = c.double()
    s = p + c64
    bb = s - p
    e = (p - (s - bb)) + (c64 - bb)
    r = s.float()
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=r.device)
    lo = torch.where(r.double() > s, torch.nextafter(r, -inf), r)
    hi = torch.nextafter(lo, inf)
    tie = (s == (lo.double() + hi.double()) * 0.5) & (e != 0)
    return torch.where(tie, torch.where(e > 0, hi, lo), r)


def sq_dist_elementwise(dx, dy, dz):
    """``dx*dx + dy*dy + dz*dz`` as fma(dz, dz, fma(dx, dx, dy*dy))."""
    return fma32(dz, dz, fma32(dx, dx, dy * dy))


def sq_dist_reduce(dx, dy, dz):
    """``sum(d**2, -1)`` as fma(dz, dz, fma(dy, dy, dx*dx))."""
    return fma32(dz, dz, fma32(dy, dy, dx * dx))


def radius_squared(radius: float) -> float:
    """radius**2 in double, rounded once to float32."""
    return float(torch.tensor(float(radius) ** 2, dtype=torch.float64
                              ).float())


# ------------------------------------------------------------ sampling
def furthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """(B, N, 3) -> (B, npoint) int32: seed index 0, points with
    |p|^2 <= 1e-3 never picked, each step the argmax of the running
    minimum squared distance, ties to the lowest index."""
    B, N, _ = xyz.shape
    x = xyz.detach().float()
    px, py, pz = x[..., 0], x[..., 1], x[..., 2]
    valid = sq_dist_reduce(px, py, pz) > 1e-3
    min_d2 = torch.where(valid, torch.full_like(px, 1e10),
                         torch.full_like(px, -1.0))
    idxs = torch.zeros((B, npoint), dtype=torch.int64, device=x.device)
    rows = torch.arange(B, device=x.device)
    last = torch.zeros((B,), dtype=torch.int64, device=x.device)
    for j in range(1, npoint):
        lp = x[rows, last]
        d2 = sq_dist_reduce(px - lp[:, 0:1], py - lp[:, 1:2], pz - lp[:, 2:3])
        min_d2 = torch.minimum(min_d2, d2)
        last = torch.argmax(min_d2, dim=-1)
        idxs[:, j] = last
    return idxs.to(torch.int32)


def gather_points(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C), (B, M) -> (B, M, C)."""
    idx = idx.long()
    return torch.gather(features, 1,
                        idx[..., None].expand(-1, -1, features.shape[-1]))


# ------------------------------------------------------------ ball query
_CHUNK = 512


def hits(xyz: torch.Tensor, new_xyz: torch.Tensor, r2: float) -> torch.Tensor:
    """(N, 3), (m, 3) -> (m, N) bool: squared distance below r2."""
    dx = new_xyz[:, None, 0] - xyz[None, :, 0]
    dy = new_xyz[:, None, 1] - xyz[None, :, 1]
    dz = new_xyz[:, None, 2] - xyz[None, :, 2]
    return sq_dist_elementwise(dx, dy, dz) < r2


def _first_k(hit: torch.Tensor, nsample: int) -> torch.Tensor:
    m, N = hit.shape
    rank = torch.cumsum(hit, dim=1, dtype=torch.int32) - 1
    keep = hit & (rank < nsample)
    rows, cols = torch.nonzero(keep, as_tuple=True)
    out = torch.zeros((m, nsample), dtype=torch.int64, device=hit.device)
    out[rows, rank[rows, cols].long()] = cols
    total = torch.clamp(hit.sum(dim=1), max=nsample)
    slot = torch.arange(nsample, device=hit.device)
    out = torch.where(slot[None, :] < total[:, None], out, out[:, :1])
    return out.to(torch.int32)


def ball_query(xyz: torch.Tensor, new_xyz: torch.Tensor, radius: float,
               nsample: int) -> torch.Tensor:
    """(B, N, 3), (B, M, 3) -> (B, M, nsample) int32: the first nsample
    points in index order strictly inside the radius, the slots past the
    hit count repeating the first hit, zeros for a query without one."""
    r2 = radius_squared(radius)
    xyz = xyz.detach().float()
    new_xyz = new_xyz.detach().float()
    B, M, _ = new_xyz.shape
    out = torch.empty((B, M, nsample), dtype=torch.int32, device=xyz.device)
    for b in range(B):
        for s in range(0, M, _CHUNK):
            out[b, s:s + _CHUNK] = _first_k(
                hits(xyz[b], new_xyz[b, s:s + _CHUNK], r2), nsample)
    return out


def group_points(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C), (B, M, S) -> (B, M, S, C), differentiable in features."""
    B, N, C = features.shape
    _, M, S = idx.shape
    flat = idx.reshape(B, M * S).long()
    out = torch.gather(features, 1, flat[..., None].expand(-1, -1, C))
    return out.reshape(B, M, S, C)


# ------------------------------------------------------------ interpolation
def three_nn(unknown: torch.Tensor, known: torch.Tensor):
    """(B, n, 3), (B, m, 3) -> distances (B, n, 3), indices (B, n, 3)
    int32; ties to the lowest index."""
    u = unknown.detach().float()
    k = known.detach().float()
    d2 = sq_dist_elementwise(u[:, :, None, 0] - k[:, None, :, 0],
                             u[:, :, None, 1] - k[:, None, :, 1],
                             u[:, :, None, 2] - k[:, None, :, 2])
    vals, idx = torch.sort(d2, dim=-1, stable=True)
    return (torch.sqrt(torch.clamp(vals[..., :3], min=0.0)),
            idx[..., :3].to(torch.int32))


def three_interpolate(features, idx, weight):
    B, n, _ = idx.shape
    C = features.shape[-1]
    flat = idx.reshape(B, n * 3).long()
    gathered = torch.gather(features, 1, flat[..., None].expand(-1, -1, C))
    return torch.sum(gathered.reshape(B, n, 3, C) * weight[..., None], dim=2)


def interpolation_weights(dist: torch.Tensor, eps: float = 1e-8):
    recip = 1.0 / (dist + eps)
    return recip / torch.sum(recip, dim=-1, keepdim=True)


# ------------------------------------------------------------ chamfer
def huber_loss(error: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    abs_error = torch.abs(error)
    quadratic = torch.clamp(abs_error, max=delta)
    return 0.5 * quadratic ** 2 + delta * (abs_error - quadratic)


def _sq_dist(diff: torch.Tensor) -> torch.Tensor:
    plain = torch.sum(diff ** 2, dim=-1)
    if diff.shape[-1] != 3:
        return plain
    with torch.no_grad():
        exact = sq_dist_reduce(diff[..., 0], diff[..., 1], diff[..., 2])
    return exact + (plain - plain.detach())


def _min_first(dist: torch.Tensor, dim: int):
    val = torch.amin(dist.detach(), dim=dim, keepdim=True)
    n = dist.shape[dim]
    shape = [1] * dist.dim()
    shape[dim] = n
    pos = torch.arange(n, device=dist.device).reshape(shape)
    idx = torch.where(dist.detach() == val, pos, n).amin(dim=dim)
    return torch.gather(dist, dim, idx.unsqueeze(dim)).squeeze(dim), idx


def nn_distance(pc1: torch.Tensor, pc2: torch.Tensor, l1: bool = False):
    """(B, N, C), (B, M, C) -> dist1 (B, N), idx1, dist2 (B, M), idx2:
    squared L2 (or L1) to the nearest point of the other set, the lowest
    index among equal minima."""
    diff = pc1[:, :, None, :] - pc2[:, None, :, :]
    dist = torch.sum(torch.abs(diff), dim=-1) if l1 else _sq_dist(diff)
    dist1, idx1 = _min_first(dist, 2)
    dist2, idx2 = _min_first(dist, 1)
    return dist1, idx1, dist2, idx2


# ------------------------------------------------------------ boxes
_SX = (1, 1, -1, -1, 1, 1, -1, -1)
_SY = (1, -1, -1, 1, 1, -1, -1, 1)
_SZ = (1, 1, 1, 1, -1, -1, -1, -1)


def box_corners(box_size: torch.Tensor, center: torch.Tensor) -> torch.Tensor:
    """Corners of boxes rotated by a zero heading about y: (..., 3),
    (..., 3) -> (..., 8, 3)."""
    kw = dict(dtype=box_size.dtype, device=box_size.device)
    sx, sy, sz = (torch.tensor(v, **kw) for v in (_SX, _SY, _SZ))
    corners = torch.stack([box_size[..., 0:1] / 2 * sx,
                           box_size[..., 1:2] / 2 * sy,
                           box_size[..., 2:3] / 2 * sz], dim=-1)
    c = torch.ones(center.shape[:-1], **kw)
    z = torch.zeros_like(c)
    rot = torch.stack([torch.stack([c, z, z], -1), torch.stack([z, c, z], -1),
                       torch.stack([-z, z, c], -1)], dim=-2)
    return einsum("...ij,...kj->...ki", rot, corners) + center[..., None, :]


def box3d_iou_batch(corners1: torch.Tensor,
                    corners2: torch.Tensor) -> torch.Tensor:
    """Elementwise axis-aligned IoU, (..., 8, 3) x (..., 8, 3) -> (...)."""
    min1, max1 = corners1.amin(dim=-2), corners1.amax(dim=-2)
    min2, max2 = corners2.amin(dim=-2), corners2.amax(dim=-2)
    e = torch.clamp(torch.minimum(max1, max2) - torch.maximum(min1, min2),
                    min=0.0)
    inter = (e[..., 0] * e[..., 1]) * e[..., 2]
    s1, s2 = max1 - min1, max2 - min2
    vol2 = (s2[..., 0] * s2[..., 1]) * s2[..., 2]
    s1x, s1y, s1z, vol2 = torch.broadcast_tensors(s1[..., 0], s1[..., 1],
                                                  s1[..., 2], vol2)
    union = fma32(s1x * s1y, s1z, vol2)
    return inter / (union - inter + 1e-8)


def box3d_iou_matrix(corners1: torch.Tensor,
                     corners2: torch.Tensor) -> torch.Tensor:
    """All-pairs axis-aligned IoU, (..., N, 8, 3) x (..., M, 8, 3) ->
    (..., N, M)."""
    min1, max1 = corners1.amin(dim=-2), corners1.amax(dim=-2)
    min2, max2 = corners2.amin(dim=-2), corners2.amax(dim=-2)
    lo = torch.maximum(min1[..., :, None, :], min2[..., None, :, :])
    hi = torch.minimum(max1[..., :, None, :], max2[..., None, :, :])
    inter = torch.prod(torch.clamp(hi - lo, min=0.0), dim=-1)
    vol1 = torch.prod(max1 - min1, dim=-1)
    vol2 = torch.prod(max2 - min2, dim=-1)
    return inter / (vol1[..., :, None] + vol2[..., None, :] - inter + 1e-8)


def ce_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-element cross entropy from logits."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels.long()[..., None])[..., 0]


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, M, ...), idx (B, K) -> (B, K, ...)."""
    idx = idx.long().reshape(idx.shape + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, idx.expand(idx.shape[:2] + x.shape[2:]))


def rotation_angle_labels(radians: torch.Tensor, num_bins: int) -> torch.Tensor:
    """[0, pi] -> ``num_bins`` classes; an angle on a bin edge k*pi/bins
    belongs to class k."""
    boundaries = torch.as_tensor(
        np.arange(math.pi / num_bins, math.pi - 1e-8, math.pi / num_bins
                  ).astype(np.float32), device=radians.device)
    return torch.bucketize(radians.float(), boundaries, right=False)
