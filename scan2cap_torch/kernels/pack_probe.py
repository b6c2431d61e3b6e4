"""Wrappers of the CUDA pack-tile probe kernels (``csrc/pack_probe.cu``).

Port ``scripts/micro_mxu_pack_probe.py`` (``_probe_kernel``) and
``scripts/micro_mxu_shift_probe.py`` (``_kernel``).  The plain PyTorch
versions are ``probes.pack.pack_probe_plain`` and
``probes.shift.shift_probe_plain``.

The product runs on the tensor cores (``wgmma``) with tf32 operands, which
keep 10 mantissa bits: a hit tile of 0/1 values, the probes' contract,
gives the float32 product bitwise; other values are truncated.  The 512
points of K are shared by the ``SPLIT`` blocks of a cluster, as the source
fixes it.  The hit tile arrives by TMA, whose tensor map needs its address
on a 16-byte boundary; the shift probe reads ``ints`` 8 bytes at a time.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from scan2cap_torch.kernels import _build

MQ = 256     # query rows of the tile
NC = 512     # points per pack step (16 uint32 words)
OUT = 128    # lane-padded output width
SPLIT = 8    # blocks of a cluster that share K (csrc/pack_probe.cu kSplit)
M_TILES = MQ // 64


_pack_launch = None
_shift_launch = None
_empty_launch = None
_shift_counts: Dict[torch.device, torch.Tensor] = {}


def _bind():
    global _pack_launch, _shift_launch, _empty_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    shape = tuple(_build.bind("pack_probe", f"pack_probe_{n}", [])()
                  for n in ("rows", "points", "split"))
    if shape != (MQ, NC, SPLIT):
        raise RuntimeError("csrc/pack_probe.cu and kernels/pack_probe.py "
                           "disagree on the tile shape or the partition")
    _pack_launch = _build.bind("pack_probe", "pack_probe_launch",
                               [p, p, p, p])
    _shift_launch = _build.bind("pack_probe", "shift_probe_launch",
                                [p, p, p, p, p])
    _empty_launch = _build.bind("pack_probe", "probe_empty_launch", [i, i, p])


def _check(t: torch.Tensor, name: str, shape, dtype, align: int) -> None:
    """Shape, dtype, contiguity and the kernel's alignment of ``t``'s
    address (a view off the boundary would fault on the card)."""
    if tuple(t.shape) != shape or t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype} {shape}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name} must start on a {align}-byte boundary, "
                         f"is {t.data_ptr() % align} bytes past one")


def _on_card(**tensors: torch.Tensor) -> torch.device:
    """The one CUDA device all ``tensors`` lie on."""
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor")
    if len({t.device for t in tensors.values()}) > 1:
        raise ValueError(f"{' and '.join(tensors)} must share a device")
    return next(iter(tensors.values())).device


def pack_probe_cuda(hit: torch.Tensor):
    """hit (1, 256, 512) float32 of 0/1 values (tf32 truncates others), on
    a 16-byte boundary -> raw (1, 256, 128) float32 (the product in columns
    0..47), word (1, 256, 128) int32 (lo | hi << 16 in 0..15)."""
    _check(hit, "hit", (1, MQ, NC), torch.float32, 16)
    _on_card(hit=hit)
    raw = torch.empty((1, MQ, OUT), dtype=torch.float32, device=hit.device)
    word = torch.empty((1, MQ, OUT), dtype=torch.int32, device=hit.device)
    if _pack_launch is None:
        _bind()
    _build.launch(_pack_launch, hit.device, hit.data_ptr(),
                  raw.data_ptr(), word.data_ptr())
    pack_probe_cuda.launches += 1
    return raw, word


def _shift_count(device: torch.device) -> torch.Tensor:
    """The shift count 16 of every word, in device memory (v5 reads it
    there, so that the compiler cannot fold it); made once per device."""
    count = _shift_counts.get(device)
    if count is None:
        count = torch.full((16,), 16, dtype=torch.int32, device=device)
        _shift_counts[device] = count
    return count


def shift_probe_cuda(hit: torch.Tensor, ints: torch.Tensor):
    """hit (1, 256, 512) float32 of 0/1 values on a 16-byte boundary, ints
    (1, 256, 128) int32 on an 8-byte one -> the six (1, 256, 128) int32
    combines v0..v5 of the shift probe."""
    _check(hit, "hit", (1, MQ, NC), torch.float32, 16)
    _check(ints, "ints", (1, MQ, OUT), torch.int32, 8)
    _on_card(hit=hit, ints=ints)
    out = torch.empty((6, 1, MQ, OUT), dtype=torch.int32, device=hit.device)
    count = _shift_count(hit.device)
    if _shift_launch is None:
        _bind()
    _build.launch(_shift_launch, hit.device, hit.data_ptr(),
                  ints.data_ptr(), count.data_ptr(), out.data_ptr())
    shift_probe_cuda.launches += 1
    return tuple(out.unbind(0))


def empty_launch_cuda(device: torch.device, blocks: int = M_TILES * SPLIT,
                      cluster: int = SPLIT) -> None:
    """Launch an empty kernel of ``blocks`` blocks of 128 threads in
    clusters of ``cluster`` (by default the probes' own grid): the floor
    under a one-launch kernel of this size.  A measurement aid, counted
    nowhere."""
    if device.type != "cuda":
        raise ValueError("the empty launch needs a CUDA device")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if blocks < 1 or cluster < 1 or blocks % cluster:
        raise ValueError(f"{blocks} blocks in clusters of {cluster}")
    if _empty_launch is None:
        _bind()
    _build.launch(_empty_launch, device, blocks, cluster)


pack_probe_cuda.launches = 0
shift_probe_cuda.launches = 0
