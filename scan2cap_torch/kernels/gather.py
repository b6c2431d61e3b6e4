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


def _lib() -> ctypes.CDLL:
    lib = _build.load("gather")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gather_rows_launch.argtypes = [p, p, i, i, i, i, p, p]
        lib.gather_rows_launch.restype = i
        lib._typed = True
    return lib


def group_points_cuda(features: torch.Tensor, idx: torch.Tensor
                      ) -> torch.Tensor:
    """features (B, N, C) float32, idx (B, M, S) int32, both CUDA and
    contiguous -> (B, M, S, C).  Indices must lie in [0, N)."""
    for name, t in (("features", features), ("idx", idx)):
        if not t.is_cuda:
            raise ValueError(f"group_points_cuda takes CUDA tensors ({name})")
        if t.dim() != 3:
            raise ValueError(f"{name} must be 3-D, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
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
    with torch.cuda.device(features.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().gather_rows_launch(features.data_ptr(), idx.data_ptr(),
                                        B, N, M * S, C, out.data_ptr(), stream)
    _build.check(err, "gather_rows_launch")
    group_points_cuda.launches += 1
    return out


group_points_cuda.launches = 0
