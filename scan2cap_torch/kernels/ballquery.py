"""Wrappers of the CUDA ball-query kernels (``csrc/ballquery.cu``).

Ports ``scan2cap_tpu/ops/pallas/ballquery.py`` (``_bq_pack_kernel``) and
the slot decode it feeds (``scan2cap_tpu/ops/grouping.py:135-233``).  The
plain PyTorch versions are ``ops.grouping.ball_query_plain`` and
``ops.grouping.ball_query_pack_plain``.
"""

from __future__ import annotations

import ctypes

import torch

from scan2cap_torch.kernels import _build


_pack_launch = None
_launch = None


def _bind():
    global _pack_launch, _launch
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    _pack_launch = _build.bind("ballquery", "ball_query_pack_launch",
                               [p, p, i, i, i, f, p, p, p])
    _launch = _build.bind("ballquery", "ball_query_launch",
                          [p, p, i, i, i, f, i, p, p])


def _check_inputs(xyz: torch.Tensor, new_xyz: torch.Tensor, what: str):
    if not xyz.is_cuda or not new_xyz.is_cuda:
        raise ValueError(f"{what} takes CUDA tensors")
    if xyz.dtype != torch.float32 or xyz.dim() != 3 or xyz.shape[-1] != 3 \
            or new_xyz.dtype != torch.float32 or new_xyz.dim() != 3 \
            or new_xyz.shape[-1] != 3:
        raise ValueError(f"xyz and new_xyz must be float32 (B, *, 3), got "
                         f"{tuple(xyz.shape)} {xyz.dtype} and "
                         f"{tuple(new_xyz.shape)} {new_xyz.dtype}")
    if not xyz.is_contiguous() or not new_xyz.is_contiguous():
        raise ValueError("xyz and new_xyz must be contiguous")
    if xyz.shape[0] != new_xyz.shape[0] or xyz.device != new_xyz.device:
        raise ValueError("xyz and new_xyz must share batch size and device")


def ball_query_pack_cuda(xyz: torch.Tensor, new_xyz: torch.Tensor,
                         r2: float):
    """(B, N, 3), (B, M, 3) -> words (B, M, W) uint32, counts (B, M, W)
    int32, W = ceil(N/32).  ``r2`` must be the f32-rounded squared radius
    (``ops.grouping.radius_squared``)."""
    _check_inputs(xyz, new_xyz, "ball_query_pack_cuda")
    B, N, _ = xyz.shape
    M = new_xyz.shape[1]
    W = -(-N // 32)
    words = torch.empty((B, M, W), dtype=torch.uint32, device=xyz.device)
    counts = torch.empty((B, M, W), dtype=torch.int32, device=xyz.device)
    if _pack_launch is None:
        _bind()
    _build.launch(_pack_launch, xyz.device, xyz.data_ptr(),
                  new_xyz.data_ptr(), B, N, M, r2, words.data_ptr(),
                  counts.data_ptr())
    ball_query_pack_cuda.launches += 1
    return words, counts


def ball_query_cuda(xyz: torch.Tensor, new_xyz: torch.Tensor, r2: float,
                    nsample: int) -> torch.Tensor:
    """(B, N, 3), (B, M, 3) -> (B, M, nsample) int32 first-k hit indices
    with the reference's padding.  ``r2`` as for ``ball_query_pack_cuda``."""
    _check_inputs(xyz, new_xyz, "ball_query_cuda")
    if nsample < 1:
        raise ValueError(f"nsample must be positive, got {nsample}")
    B, N, _ = xyz.shape
    M = new_xyz.shape[1]
    idx = torch.empty((B, M, nsample), dtype=torch.int32, device=xyz.device)
    if _launch is None:
        _bind()
    _build.launch(_launch, xyz.device, xyz.data_ptr(), new_xyz.data_ptr(),
                  B, N, M, r2, nsample, idx.data_ptr())
    ball_query_cuda.launches += 1
    return idx


ball_query_pack_cuda.launches = 0
ball_query_cuda.launches = 0
