"""Wrapper of the CUDA furthest-point-sampling kernel (``csrc/fps.cu``).

Ports ``scan2cap_tpu/ops/pallas/fps.py`` (``_fps_kernel``).  The plain
PyTorch version of the same function is ``ops.sampling.furthest_point_sample_plain``.

The kernel keeps a scene on chip, spread over ``cluster`` thread blocks of
``threads`` threads with ``points`` points each in registers.  Which of its
variants a scene gets depends on N alone (``fps_variant``); a scene larger
than the largest variant is refused.
"""

from __future__ import annotations

import ctypes

import torch

from scan2cap_torch.kernels import _build

# (cluster size, threads per block, points per thread); the same list, in
# the same order, as kVariants of csrc/fps.cu (checked when the library is
# loaded).  Several variants hold the same N: the probe
# ``python -m scan2cap_torch.probes.fps_variants`` times them all.
VARIANTS = (
    (1, 32, 16), (1, 128, 4), (1, 128, 8), (1, 256, 2), (1, 256, 4),
    (1, 256, 8), (1, 512, 2), (1, 512, 4), (1, 1024, 2),
    (8, 256, 4), (8, 256, 8), (8, 256, 12), (8, 256, 16), (8, 256, 20),
    (8, 256, 24), (8, 256, 32), (8, 256, 40),
    (8, 128, 40), (8, 512, 10), (8, 1024, 5),
)

# The variant by scene size: the first row whose bound is >= N.  One block
# while a block's registers hold the scene (no exchange between blocks), a
# cluster of 8 blocks above that; few warps with many points each, because
# the argmax across warps costs more than the arithmetic.
_BY_SIZE = (
    (512, (1, 128, 4)),
    (1024, (1, 256, 4)),
    (2048, (1, 512, 4)),
    (8192, (8, 256, 4)),
    (16384, (8, 256, 8)),
    (24576, (8, 256, 12)),
    (32768, (8, 256, 16)),
    (40960, (8, 256, 20)),
    (49152, (8, 256, 24)),
    (65536, (8, 256, 32)),
    (81920, (8, 256, 40)),
)


def variant_points(variant: int) -> int:
    """The largest scene variant ``variant`` holds."""
    cluster, threads, points = VARIANTS[variant]
    return cluster * threads * points


def fps_max_points() -> int:
    """The largest scene the kernel takes: what the largest variant's
    registers hold."""
    return _BY_SIZE[-1][0]


def fps_variant(n: int) -> int:
    """Index into ``VARIANTS`` of the variant a scene of ``n`` points gets."""
    if n < 1:
        raise ValueError(f"N={n} outside the kernel's 1..{fps_max_points()}")
    for bound, shape in _BY_SIZE:
        if n <= bound:
            return VARIANTS.index(shape)
    raise ValueError(f"N={n} outside the kernel's 1..{fps_max_points()}")


_launch = None


def _bind():
    """The typed ``fps_launch``, after a check that the library's variants
    are the ones listed here."""
    global _launch
    p, i = ctypes.c_void_p, ctypes.c_int
    info = _build.bind("fps", "fps_variant_info",
                       [i, ctypes.POINTER(i), ctypes.POINTER(i),
                        ctypes.POINTER(i)])
    count = _build.bind("fps", "fps_num_variants", [])()
    built = []
    for v in range(count):
        c, t, n = i(), i(), i()
        info(v, ctypes.byref(c), ctypes.byref(t), ctypes.byref(n))
        built.append((c.value, t.value, n.value))
    if tuple(built) != VARIANTS:
        raise RuntimeError("csrc/fps.cu and kernels/fps.py disagree on the "
                           "kernel's variants")
    _launch = _build.bind("fps", "fps_launch", [p, i, i, i, p, i, p])
    return _launch


def furthest_point_sample_cuda(xyz: torch.Tensor, npoint: int,
                               variant: int | None = None) -> torch.Tensor:
    """(B, N, 3) float32 CUDA tensor -> (B, npoint) int32 indices.

    ``variant`` overrides the choice by size (the probe that times the
    variants uses it); it must hold N points."""
    if xyz.dtype != torch.float32 or xyz.dim() != 3 or xyz.shape[-1] != 3:
        raise ValueError(f"xyz must be float32 (B, N, 3), got "
                         f"{tuple(xyz.shape)} {xyz.dtype}")
    B, N, _ = xyz.shape
    if variant is None:
        variant = fps_variant(N)
    elif not (0 <= variant < len(VARIANTS) and 1 <= N <= variant_points(variant)):
        raise ValueError(f"variant {variant} does not hold N={N}")
    if npoint < 1:
        raise ValueError(f"npoint must be positive, got {npoint}")
    if not xyz.is_cuda:
        raise ValueError("furthest_point_sample_cuda takes a CUDA tensor")
    if not xyz.is_contiguous():
        raise ValueError("xyz must be contiguous")
    out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    _build.launch(_launch or _bind(), xyz.device, xyz.data_ptr(), B, N,
                  npoint, out.data_ptr(), variant)
    furthest_point_sample_cuda.launches += 1
    return out


furthest_point_sample_cuda.launches = 0
