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


_pack_launch = None
_shift_launch = None


def _bind():
    global _pack_launch, _shift_launch
    p = ctypes.c_void_p
    rows = _build.bind("pack_probe", "pack_probe_rows", [])()
    points = _build.bind("pack_probe", "pack_probe_points", [])()
    if (rows, points) != (MQ, NC):
        raise RuntimeError("csrc/pack_probe.cu and kernels/pack_probe.py "
                           "disagree on the tile shape")
    _pack_launch = _build.bind("pack_probe", "pack_probe_launch", [p, p, p, p])
    _shift_launch = _build.bind("pack_probe", "shift_probe_launch",
                                [p, p, p, p, p])


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
    if _pack_launch is None:
        _bind()
    _build.launch(_pack_launch, hit.device, hit.data_ptr(), raw.data_ptr(),
                  word.data_ptr())
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
    if _shift_launch is None:
        _bind()
    _build.launch(_shift_launch, hit.device, hit.data_ptr(), ints.data_ptr(),
                  count.data_ptr(), out.data_ptr())
    shift_probe_cuda.launches += 1
    return tuple(out.unbind(0))


pack_probe_cuda.launches = 0
shift_probe_cuda.launches = 0
