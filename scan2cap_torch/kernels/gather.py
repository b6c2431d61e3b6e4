"""Wrapper of the CUDA row-gather kernel (``csrc/gather.cu``).

Ports the two kernels of ``scripts/micro_vmem_gather.py`` (``vmem_gather``
and ``vmem_gather_vec``, one function).  The plain PyTorch version of the
same function is ``ops.grouping.group_points_plain``; the autograd wrapper
around this kernel is ``ops.grouping.group_points``.
"""

from __future__ import annotations

import ctypes

import torch

from scan2cap_torch.kernels import _build


def gather_vector_bytes(channels: int, features_ptr: int, out_ptr: int) -> int:
    """Bytes per load and store of the gather: the widest of 16, 8 and 4
    that divides a row's bytes and both base addresses, so that every row
    of the table and of the output starts on that boundary."""
    row_bytes = 4 * channels
    for width in (16, 8):
        if row_bytes % width == 0 and features_ptr % width == 0 \
                and out_ptr % width == 0:
            return width
    return 4


_launch = None


def _bind():
    global _launch
    p, i = ctypes.c_void_p, ctypes.c_int
    _launch = _build.bind("gather", "gather_rows_launch",
                          [p, p, i, i, i, i, i, p, p])
    return _launch


def group_points_cuda(features: torch.Tensor, idx: torch.Tensor
                      ) -> torch.Tensor:
    """features (B, N, C) float32, idx (B, M, S) int32, both CUDA and
    contiguous -> (B, M, S, C).  Indices must lie in [0, N)."""
    if not features.is_cuda or not idx.is_cuda:
        raise ValueError("group_points_cuda takes CUDA tensors")
    if features.dim() != 3 or idx.dim() != 3:
        raise ValueError(f"features and idx must be 3-D, got "
                         f"{tuple(features.shape)} and {tuple(idx.shape)}")
    if not features.is_contiguous() or not idx.is_contiguous():
        raise ValueError("features and idx must be contiguous")
    if features.dtype != torch.float32 or idx.dtype != torch.int32:
        raise ValueError(f"features must be float32 and idx int32, got "
                         f"{features.dtype} and {idx.dtype}")
    if features.shape[0] != idx.shape[0] or features.device != idx.device:
        raise ValueError("features and idx must share batch size and device")
    B, N, C = features.shape
    _, M, S = idx.shape
    if N < 1 or C < 1 or M * S >= 2 ** 31:
        raise ValueError(f"unsupported table shape {tuple(features.shape)}")
    out = torch.empty((B, M, S, C), dtype=torch.float32,
                      device=features.device)
    src, dst = features.data_ptr(), out.data_ptr()
    _build.launch(_launch or _bind(), features.device, src, idx.data_ptr(),
                  B, N, M * S, C, gather_vector_bytes(C, src, dst), dst)
    group_points_cuda.launches += 1
    return out


group_points_cuda.launches = 0
