"""Furthest-point sampling's work: every point read once, the picks
written, and for each of the npoint - 1 steps the distance update of
every point (3 differences, 3 fused multiply-adds, a minimum and the
arg-max's compare and select: 9 operations).  One pick is index 0: only
it is written."""

from __future__ import annotations

from h100bench.work import bound_s

OPS_PER_POINT = 9
KERNELS = ("fps_kernel", "fps_stream_kernel")


def call_bound_s(B: int, N: int, npoint: int) -> float:
    if npoint == 1:
        return bound_s(B * 4, 0)
    return bound_s(B * N * 12 + B * npoint * 4,
                   B * (npoint - 1) * N * OPS_PER_POINT)


def sites_bound_s(sites) -> float:
    return sum(call_bound_s(*call) for call in sites.fps)
