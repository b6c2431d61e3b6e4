"""Wrapper of the CUDA furthest-point-sampling kernel (``csrc/fps.cu``).

Ports ``scan2cap_tpu/ops/pallas/fps.py`` (``_fps_kernel``).  The plain
PyTorch version of the same function is ``ops.sampling.furthest_point_sample_plain``.

The kernel keeps a scene on chip, spread over ``cluster`` thread blocks of
``threads`` threads with ``points`` points each in registers, up to
``REGISTER_POINTS`` points (a cluster of 8 blocks up to 81,920, of 16
above); above that ``shared`` more points a thread keep their state in
shared memory, up to ``ON_CHIP_POINTS``; a larger scene streams from a
workspace in device memory (the variants with ``points`` 0, no size
limit).  Which variant a scene gets depends on N alone (``fps_variant``).
"""

from __future__ import annotations

import ctypes

import torch

from scan2cap_torch.kernels import _build

# (cluster size, threads per block, points per thread in registers, most
# points per thread in shared memory); the same list, in the same order, as
# kVariants of csrc/fps.cu (checked when the library is loaded).  Several
# variants hold the same N: the probe
# ``python -m scan2cap_torch.probes.fps_variants`` times them all.
VARIANTS = (
    (1, 32, 16, 0), (1, 128, 4, 0), (1, 128, 8, 0), (1, 256, 2, 0),
    (1, 256, 4, 0), (1, 256, 8, 0), (1, 512, 2, 0), (1, 512, 4, 0),
    (1, 1024, 2, 0),
    (8, 256, 4, 0), (8, 256, 8, 0), (8, 256, 12, 0), (8, 256, 16, 0),
    (8, 256, 20, 0), (8, 256, 24, 0), (8, 256, 32, 0), (8, 256, 40, 0),
    (8, 128, 40, 0), (8, 512, 10, 0), (8, 1024, 5, 0),
    (16, 256, 24, 0), (16, 256, 28, 0), (16, 256, 32, 0), (16, 256, 36, 0),
    (16, 256, 40, 0), (16, 512, 20, 0),
    (16, 256, 40, 26), (16, 512, 20, 13),
    (8, 1024, 0, 0), (16, 1024, 0, 0),
)

# The variant by scene size: the first row whose bound is >= N, the last row
# above that.  One block while a block's registers hold the scene (no
# exchange between blocks), a cluster of 8 blocks above that and of 16
# above what 8 hold; few warps with many points each, because the argmax
# across warps costs more than the arithmetic.  Above what 16 blocks'
# registers hold, the shared-state tier; above what it holds on chip, the
# scene streams from device memory through 8 blocks of 1,024 threads.
_BY_SIZE = (
    (512, (1, 128, 4, 0)),
    (1024, (1, 256, 4, 0)),
    (2048, (1, 512, 4, 0)),
    (8192, (8, 256, 4, 0)),
    (16384, (8, 256, 8, 0)),
    (24576, (8, 256, 12, 0)),
    (32768, (8, 256, 16, 0)),
    (40960, (8, 256, 20, 0)),
    (49152, (8, 256, 24, 0)),
    (65536, (8, 256, 32, 0)),
    (81920, (8, 256, 40, 0)),
    (98304, (16, 256, 24, 0)),
    (114688, (16, 256, 28, 0)),
    (131072, (16, 256, 32, 0)),
    (147456, (16, 256, 36, 0)),
    (163840, (16, 256, 40, 0)),
    (270336, (16, 256, 40, 26)),
    (None, (8, 1024, 0, 0)),
)

# the largest scene a variant holds in registers, and on chip
REGISTER_POINTS = _BY_SIZE[-3][0]
ON_CHIP_POINTS = _BY_SIZE[-2][0]


def variant_points(variant: int) -> int | None:
    """The largest scene variant ``variant`` holds; None for no limit."""
    cluster, threads, points, shared = VARIANTS[variant]
    return cluster * threads * (points + shared) if points else None


def tier(variant: int) -> str:
    """Where a variant keeps a scene: ``registers`` (one block or a cluster
    of 8), ``cluster16`` (registers of a cluster of 16), ``shared_state``
    (registers and shared memory of 16 blocks) or ``streamed``."""
    cluster, _, points, shared = VARIANTS[variant]
    if not points:
        return "streamed"
    if shared:
        return "shared_state"
    return "cluster16" if cluster == 16 else "registers"


def fps_variant(n: int) -> int:
    """Index into ``VARIANTS`` of the variant a scene of ``n`` points gets."""
    if n < 1:
        raise ValueError(f"N={n} outside the kernel's N >= 1")
    for bound, shape in _BY_SIZE:
        if bound is None or n <= bound:
            return VARIANTS.index(shape)
    raise AssertionError("the last row of _BY_SIZE has no bound")


_launch = None


def _bind():
    """The typed ``fps_launch``, after a check that the library's variants
    are the ones listed here."""
    global _launch
    p, i = ctypes.c_void_p, ctypes.c_int
    ip = ctypes.POINTER(i)
    info = _build.bind("fps", "fps_variant_info", [i, ip, ip, ip, ip])
    count = _build.bind("fps", "fps_num_variants", [])()
    built = []
    for v in range(count):
        shape = [i() for _ in range(4)]
        info(v, *(ctypes.byref(x) for x in shape))
        built.append(tuple(x.value for x in shape))
    if tuple(built) != VARIANTS:
        raise RuntimeError("csrc/fps.cu and kernels/fps.py disagree on the "
                           "kernel's variants")
    _launch = _build.bind("fps", "fps_launch", [p, i, i, i, p, i, p, p])
    return _launch


def furthest_point_sample_cuda(xyz: torch.Tensor, npoint: int,
                               variant: int | None = None) -> torch.Tensor:
    """(B, N, 3) float32 CUDA tensor -> (B, npoint) int32 indices.

    ``variant`` overrides the choice by size (the probe that times the
    variants uses it); it must hold N points.  A streaming variant gets a
    (B, N, 4) float32 workspace from PyTorch's allocator; a 16-block
    variant the card cannot place raises."""
    if xyz.dtype != torch.float32 or xyz.dim() != 3 or xyz.shape[-1] != 3:
        raise ValueError(f"xyz must be float32 (B, N, 3), got "
                         f"{tuple(xyz.shape)} {xyz.dtype}")
    B, N, _ = xyz.shape
    if variant is None:
        variant = fps_variant(N)
    elif not (0 <= variant < len(VARIANTS) and 1 <= N
              and (variant_points(variant) or N) >= N):
        raise ValueError(f"variant {variant} does not hold N={N}")
    if npoint < 1:
        raise ValueError(f"npoint must be positive, got {npoint}")
    if not xyz.is_cuda:
        raise ValueError("furthest_point_sample_cuda takes a CUDA tensor")
    if not xyz.is_contiguous():
        raise ValueError("xyz must be contiguous")
    out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    work = (None if VARIANTS[variant][2] else
            torch.empty((B, N, 4), dtype=torch.float32, device=xyz.device))
    _build.launch(_launch or _bind(), xyz.device, xyz.data_ptr(), B, N,
                  npoint, out.data_ptr(), variant,
                  None if work is None else work.data_ptr())
    furthest_point_sample_cuda.launches += 1
    where = tier(variant)
    if where != "registers":
        name = f"{where}_launches"
        setattr(furthest_point_sample_cuda, name,
                getattr(furthest_point_sample_cuda, name) + 1)
    return out


furthest_point_sample_cuda.launches = 0
# of those, the launches of each tier above what 8 blocks' registers hold
TIERS = ("cluster16", "shared_state", "streamed")
furthest_point_sample_cuda.cluster16_launches = 0
furthest_point_sample_cuda.shared_state_launches = 0
furthest_point_sample_cuda.streamed_launches = 0
