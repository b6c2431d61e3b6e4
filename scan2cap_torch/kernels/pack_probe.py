"""Wrappers of the CUDA pack-tile probe kernels (``csrc/pack_probe.cu``).

Port ``scripts/micro_mxu_pack_probe.py`` (``_probe_kernel``) and
``scripts/micro_mxu_shift_probe.py`` (``_kernel``).  The plain PyTorch
versions are ``probes.pack.pack_probe_plain`` and
``probes.shift.shift_probe_plain``.
"""

from __future__ import annotations

import ctypes

import torch

from scan2cap_torch.kernels import _build

MQ = 256     # query rows of the tile
NC = 512     # points per pack step (16 uint32 words)
OUT = 128    # lane-padded output width


def _lib() -> ctypes.CDLL:
    lib = _build.load("pack_probe")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.pack_probe_launch.argtypes = [p, p, p, p]
        lib.pack_probe_launch.restype = i
        lib.shift_probe_launch.argtypes = [p, p, p, p, p]
        lib.shift_probe_launch.restype = i
        lib.pack_probe_rows.restype = i
        lib.pack_probe_points.restype = i
        if (lib.pack_probe_rows(), lib.pack_probe_points()) != (MQ, NC):
            raise RuntimeError("csrc/pack_probe.cu and kernels/pack_probe.py "
                               "disagree on the tile shape")
        lib._typed = True
    return lib


def _check(t: torch.Tensor, name: str, shape, dtype) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if tuple(t.shape) != shape or t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype} {shape}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def pack_probe_cuda(hit: torch.Tensor):
    """hit (1, 256, 512) float32 -> raw (1, 256, 128) float32 (the product
    in columns 0..47), word (1, 256, 128) int32 (lo | hi << 16 in 0..15)."""
    _check(hit, "hit", (1, MQ, NC), torch.float32)
    raw = torch.empty((1, MQ, OUT), dtype=torch.float32, device=hit.device)
    word = torch.empty((1, MQ, OUT), dtype=torch.int32, device=hit.device)
    with torch.cuda.device(hit.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().pack_probe_launch(hit.data_ptr(), raw.data_ptr(),
                                       word.data_ptr(), stream)
    _build.check(err, "pack_probe_launch")
    pack_probe_cuda.launches += 1
    return raw, word


def shift_probe_cuda(hit: torch.Tensor, ints: torch.Tensor):
    """hit (1, 256, 512) float32, ints (1, 256, 128) int32 -> the six
    (1, 256, 128) int32 combines v0..v5 of the shift probe."""
    _check(hit, "hit", (1, MQ, NC), torch.float32)
    _check(ints, "ints", (1, MQ, OUT), torch.int32)
    if ints.device != hit.device:
        raise ValueError("hit and ints must share a device")
    out = torch.empty((6, 1, MQ, OUT), dtype=torch.int32, device=hit.device)
    count = torch.full((16,), 16, dtype=torch.int32, device=hit.device)
    with torch.cuda.device(hit.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().shift_probe_launch(hit.data_ptr(), ints.data_ptr(),
                                        count.data_ptr(), out.data_ptr(),
                                        stream)
    _build.check(err, "shift_probe_launch")
    shift_probe_cuda.launches += 1
    return tuple(out.unbind(0))


pack_probe_cuda.launches = 0
shift_probe_cuda.launches = 0
