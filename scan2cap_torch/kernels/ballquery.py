"""Wrappers of the CUDA ball-query kernels (``csrc/ballquery.cu``).

Ports ``scan2cap_tpu/ops/pallas/ballquery.py`` (``_bq_pack_kernel``) and
the slot decode it feeds (``scan2cap_tpu/ops/grouping.py:135-233``).  The
plain PyTorch versions are ``ops.grouping.ball_query_plain`` and
``ops.grouping.ball_query_pack_plain``.

A block of the kernel owns a tile of queries and streams the scene through
shared memory.  A variant is (queries per warp Q, query warps G, ranges of
the scene R, points per chunk C): a block of G*R warps takes G*Q queries,
and warp (g, r) tests its Q queries against range r.  The first-k entry
point keeps a list of at most ``nsample`` hits per query and range in
shared memory, up to ``BQ_SHARED_NSAMPLE``.  A variant with R = 0 is the
ordered scan (``bq_ordered_kernel``): Q queries a block, all of its G warps
on them, the scene walked chunk by chunk and each hit ranked in scan order
as it is found, so that no list is kept and ``nsample`` has no bound; it
takes the first-k above ``BQ_SHARED_NSAMPLE`` (and any first-k when forced),
not the pack.  Which variant a call gets depends on its shape
(``bq_variant``).  Neither entry point allocates more than its outputs.
"""

from __future__ import annotations

import ctypes
import re
from typing import Optional, Tuple

import torch

from scan2cap_torch.kernels import _build

# (queries per warp, query warps, ranges, chunk points); with ranges 0 the
# ordered scan's (queries a block, warps, 0, chunk points: 4 to 32 words a
# warp, whole groups of 4).  The same list, in the same order, as kVariants
# of csrc/ballquery.cu (checked when the library is loaded).
# ``python -m scan2cap_torch.probes.bq_variants`` times them all.
VARIANTS = (
    (8, 2, 4, 512), (8, 4, 4, 512), (8, 2, 8, 256), (8, 1, 8, 256),
    (8, 1, 4, 512), (8, 1, 4, 256), (4, 4, 4, 512), (4, 2, 8, 256),
    (4, 4, 8, 256), (4, 2, 4, 512), (4, 2, 2, 512), (4, 1, 4, 512),
    (2, 2, 4, 512), (4, 2, 1, 2048),
    (1, 8, 0, 1024), (1, 4, 0, 2048), (4, 4, 0, 2048), (8, 4, 0, 1024),
    (8, 4, 0, 2048), (8, 2, 0, 1024), (8, 8, 0, 4096), (16, 4, 0, 2048),
)

# The variant by scene size up to BQ_SHARED_NSAMPLE: the first row whose
# bound is >= N, the last row above that.  Small scenes are a few chunks
# and few queries: small tiles, so that there are blocks enough, and 4
# ranges, so that a warp's scan is short; a large scene takes 8 queries a
# warp and splits into 4 ranges, so that the first layer's 4,096 queries
# make 2,048 warps in 256 blocks.  (8, 4, 4, 512) reads 3% less there at
# B=2 with half as many blocks.
_BY_SIZE = (
    (2048, (4, 2, 4, 512)),
    (None, (8, 2, 4, 512)),
)
# Above BQ_SHARED_NSAMPLE the ordered scan, by queries a scene: a few
# queries (MaskVoteNet's aggregation has one) get a block each, all of its
# warps on that query; many share a block eight at a time.
_ORDERED_BY_QUERIES = (
    (16, (1, 8, 0, 1024)),
    (None, (8, 4, 0, 2048)),
)

# what a block can use on sm_90 (kMaxSharedBytes of the source)
MAX_SHARED_BYTES = 232448
# the largest nsample whose hit lists the variants with ranges keep in
# shared memory; a larger nsample takes the ordered scan
BQ_SHARED_NSAMPLE = 256


def ordered_scan(nsample: int) -> bool:
    """Whether the first-k at ``nsample`` takes the ordered scan."""
    return nsample > BQ_SHARED_NSAMPLE


def is_ordered(variant: int) -> bool:
    """Whether ``variant`` is an ordered scan's (no ranges)."""
    return VARIANTS[variant][2] == 0


def takes(variant: int, nsample: int, pack: bool = False) -> bool:
    """Whether ``variant`` takes a first-k at ``nsample`` (or the pack):
    a variant with ranges takes the pack and nsample up to
    BQ_SHARED_NSAMPLE, an ordered one any first-k and no pack."""
    if is_ordered(variant):
        return not pack
    return pack or not ordered_scan(nsample)


def bq_variant(n: int, m: int = 1, nsample: int = 1) -> int:
    """Index into ``VARIANTS`` of the variant a call with ``n`` points,
    ``m`` queries a scene and ``nsample`` slots gets: up to
    BQ_SHARED_NSAMPLE a variant with ranges by N, above it the ordered
    scan by M."""
    if n < 1 or m < 0 or nsample < 1:
        raise ValueError(f"N={n}, M={m}, nsample={nsample} outside the "
                         f"kernel's N >= 1, nsample >= 1")
    by, key = ((_ORDERED_BY_QUERIES, m) if ordered_scan(nsample)
               else (_BY_SIZE, n))
    for bound, shape in by:
        if bound is None or key <= bound:
            return VARIANTS.index(shape)
    raise AssertionError("the last row of a variant table has no bound")


def shared_bytes(variant: int, nsample: int, pack: bool = False) -> int:
    """Dynamic shared memory of one block.  With ranges: two chunk buffers
    per range, and for the first-k the hit counts and lists; the ordered
    scan: two chunk buffers, a count per query and warp for two chunks,
    and the first hit of each query."""
    if not takes(variant, nsample, pack):
        raise ValueError(f"variant {VARIANTS[variant]} does not take "
                         f"{'the pack' if pack else f'nsample {nsample}'}")
    q, g, r, c = VARIANTS[variant]
    if r == 0:
        return 2 * (3 * c + 4) * 4 + q * (2 * g + 1) * 4
    lists = 0 if pack else g * q * r * (nsample + 1) * 4
    return r * 2 * (3 * c + 4) * 4 + lists


def range_words(n: int, ranges: int) -> Tuple[int, int]:
    """(words of a scene, words of one range): a scene of ``n`` points is
    ceil(n / 32) words, split into ``ranges`` contiguous runs of whole
    words, the last of which may be short or empty."""
    words = -(-n // 32)
    return words, -(-words // ranges)


def copy_plan(address: int, nfloats: int) -> Tuple[int, int, int, int]:
    """How a chunk of ``nfloats`` floats at byte ``address`` is copied into
    its 16-byte-aligned buffer: (offset, head, body, tail).  The chunk is
    stored ``offset`` floats into the buffer (as many as its source lies
    past a 16-byte boundary); ``head`` floats go by 4-byte copies up to the
    source's first boundary, ``body`` 16-byte copies follow, ``tail`` floats
    are left for 4-byte copies."""
    if address % 4:
        raise ValueError("float32 data is 4-byte aligned")
    offset = (address >> 2) & 3
    head = min(nfloats, (4 - offset) & 3)
    body = (nfloats - head) >> 2
    return offset, head, body, nfloats - head - 4 * body


_MANGLED = re.compile(r"bq_kernelILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELb([01])EE")
_DEMANGLED = re.compile(r"bq_kernel<\s*(\d+),\s*(\d+),\s*(\d+),\s*(\d+),"
                        r"\s*(?:\(bool\))?\s*(\w+)\s*>")
_ORDERED_MANGLED = re.compile(r"bq_ordered_kernelILi(\d+)ELi(\d+)ELi(\d+)EE")
_ORDERED_DEMANGLED = re.compile(
    r"bq_ordered_kernel<\s*(\d+),\s*(\d+),\s*(\d+)\s*>")


def kernel_of_name(name: str) -> Optional[Tuple[int, bool]]:
    """(variant, pack) of a ball-query kernel from its name, mangled as in
    the build log or demangled as in a profiler trace; None for any other
    kernel."""
    found = _MANGLED.search(name) or _DEMANGLED.search(name)
    if found is not None:
        shape = tuple(int(x) for x in found.groups()[:4])
        pack = found.group(5) in ("1", "true")
    else:
        found = _ORDERED_MANGLED.search(name) or _ORDERED_DEMANGLED.search(name)
        if found is None:
            return None
        q, g, c = (int(x) for x in found.groups())
        shape, pack = (q, g, 0, c), False
    if shape not in VARIANTS:
        return None
    return VARIANTS.index(shape), pack


_pack_launch = None
_launch = None


def _bind():
    """Bind both entry points, after a check that the library's variants
    are the ones listed here."""
    global _pack_launch, _launch
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ip = ctypes.POINTER(i)
    info = _build.bind("ballquery", "bq_variant_info", [i, ip, ip, ip, ip])
    count = _build.bind("ballquery", "bq_num_variants", [])()
    built = []
    for v in range(count):
        shape = [i() for _ in range(4)]
        info(v, *(ctypes.byref(x) for x in shape))
        built.append(tuple(x.value for x in shape))
    if tuple(built) != VARIANTS:
        raise RuntimeError("csrc/ballquery.cu and kernels/ballquery.py "
                           "disagree on the kernel's variants")
    _pack_launch = _build.bind("ballquery", "ball_query_pack_launch",
                               [p, p, i, i, i, f, p, p, i, p])
    _launch = _build.bind("ballquery", "ball_query_launch",
                          [p, p, i, i, i, f, i, p, i, p])


def _prepare(xyz: torch.Tensor, new_xyz: torch.Tensor, nsample: int,
             variant: int | None, what: str, pack: bool = False) -> int:
    """Check a call's tensors and return the variant it gets."""
    if xyz.dtype != torch.float32 or xyz.dim() != 3 or xyz.shape[-1] != 3 \
            or new_xyz.dtype != torch.float32 or new_xyz.dim() != 3 \
            or new_xyz.shape[-1] != 3:
        raise ValueError(f"xyz and new_xyz must be float32 (B, *, 3), got "
                         f"{tuple(xyz.shape)} {xyz.dtype} and "
                         f"{tuple(new_xyz.shape)} {new_xyz.dtype}")
    chosen = bq_variant(xyz.shape[1], new_xyz.shape[1], nsample)  # or raises
    if variant is None:
        variant = chosen
    elif not 0 <= variant < len(VARIANTS):
        raise ValueError(f"no variant {variant}")
    elif not takes(variant, nsample, pack):
        raise ValueError(f"variant {VARIANTS[variant]} does not take "
                         f"{'the pack' if pack else f'nsample {nsample}'}")
    if not xyz.is_cuda or not new_xyz.is_cuda:
        raise ValueError(f"{what} takes CUDA tensors")
    if not xyz.is_contiguous() or not new_xyz.is_contiguous():
        raise ValueError("xyz and new_xyz must be contiguous")
    if xyz.shape[0] != new_xyz.shape[0] or xyz.device != new_xyz.device:
        raise ValueError("xyz and new_xyz must share batch size and device")
    return variant


def ball_query_pack_cuda(xyz: torch.Tensor, new_xyz: torch.Tensor,
                         r2: float, variant: int | None = None):
    """(B, N, 3), (B, M, 3) -> words (B, M, W) uint32, counts (B, M, W)
    int32, W = ceil(N/32).  ``r2`` must be the f32-rounded squared radius
    (``ops.grouping.radius_squared``).  ``variant`` overrides the choice by
    shape (the probe that times the variants uses it)."""
    variant = _prepare(xyz, new_xyz, 1, variant, "ball_query_pack_cuda",
                       pack=True)
    B, N, _ = xyz.shape
    M = new_xyz.shape[1]
    W = -(-N // 32)
    words = torch.empty((B, M, W), dtype=torch.uint32, device=xyz.device)
    counts = torch.empty((B, M, W), dtype=torch.int32, device=xyz.device)
    if _pack_launch is None:
        _bind()
    _build.launch(_pack_launch, xyz.device, xyz.data_ptr(),
                  new_xyz.data_ptr(), B, N, M, r2, words.data_ptr(),
                  counts.data_ptr(), variant)
    ball_query_pack_cuda.launches += 1
    return words, counts


def ball_query_cuda(xyz: torch.Tensor, new_xyz: torch.Tensor, r2: float,
                    nsample: int, variant: int | None = None) -> torch.Tensor:
    """(B, N, 3), (B, M, 3) -> (B, M, nsample) int32 first-k hit indices
    with the reference's padding, for any ``nsample`` >= 1 (above
    ``BQ_SHARED_NSAMPLE`` through the ordered scan).  Allocates ``idx``
    alone.  ``r2`` and ``variant`` as for ``ball_query_pack_cuda``."""
    variant = _prepare(xyz, new_xyz, nsample, variant, "ball_query_cuda")
    B, N, _ = xyz.shape
    M = new_xyz.shape[1]
    idx = torch.empty((B, M, nsample), dtype=torch.int32, device=xyz.device)
    if _launch is None:
        _bind()
    _build.launch(_launch, xyz.device, xyz.data_ptr(), new_xyz.data_ptr(),
                  B, N, M, r2, nsample, idx.data_ptr(), variant)
    ball_query_cuda.launches += 1
    ball_query_cuda.ordered_launches += is_ordered(variant)
    return idx


ball_query_pack_cuda.launches = 0
ball_query_cuda.launches = 0
# of those, the launches of the ordered scan
ball_query_cuda.ordered_launches = 0
