"""Shift/combine probe (counterpart of ``scripts/micro_mxu_shift_probe.py``).

The pack product's low and high half-word columns, converted from float32
to int32, are combined into a word in six ways on the same operands:

  v0: lo | (hi << 16)
  v1: lo | (hi * 65536)          (integer multiply instead of the shift)
  v2: lo + (hi << 16)            (add instead of or)
  v3: lo | ((hi << 8) << 8)      (split shift)
  v4: shift of an int32 INPUT    (no conversion before the shift)
  v5: lo | (hi << s), s = 16 read from memory (a shift count per lane)

Every variant must give the exact word.

Run:  python -m scan2cap_torch.probes.shift       (exit 1 on a wrong row)
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Tuple

import numpy as np
import torch

from scan2cap_torch.device import resolve_device
from scan2cap_torch.kernels.pack_probe import MQ, OUT, shift_probe_cuda
from scan2cap_torch.probes.pack import (VALS, crafted_hits, half_words,
                                        pad_columns)

NAMES = ("v0 or-shift", "v1 or-mul", "v2 add-shift", "v3 split-shift",
         "v4 input-shift", "v5 vec-shift")


def shift_probe_plain(hit: torch.Tensor, ints: torch.Tensor):
    """Plain PyTorch version of the probe kernel: six (1, MQ, 128) int32."""
    _, lo, hi = half_words(hit)
    count = torch.full_like(hi, 16)
    outs = (lo | (hi << 16), lo | (hi * 65536), lo + (hi << 16),
            lo | ((hi << 8) << 8), ints[0, :, 0:16] << 16, lo | (hi << count))
    return tuple(pad_columns(o) for o in outs)


def shift_probe(hit: torch.Tensor, ints: torch.Tensor):
    """The probe on ``hit``'s device: the kernel on a CUDA tensor (or an
    error), the plain version on a CPU tensor."""
    if hit.is_cuda:
        return shift_probe_cuda(hit.contiguous(), ints.contiguous())
    if hit.device.type != "cpu":
        raise ValueError(f"unsupported device {hit.device}")
    return shift_probe_plain(hit, ints)


def crafted_ints(vals=VALS) -> np.ndarray:
    """(1, MQ, 128) int32: row r holds ``vals[r]`` in columns 0..15."""
    ints = np.zeros((1, MQ, OUT), np.int32)
    for r, v in enumerate(vals):
        ints[0, r, 0:16] = v
    return ints


def run(device: str | torch.device = "cuda") -> Tuple[List[str], int]:
    """Run the probe on ``device``; returns the table's lines and the
    number of variants with a wrong row."""
    dev = resolve_device(device)
    hit = torch.from_numpy(crafted_hits()).to(dev)
    ints = torch.from_numpy(crafted_ints()).to(dev)
    outs = [o.cpu().numpy() for o in shift_probe(hit, ints)]
    lines = [f"{'target':>7} " + " ".join(f"{n:>14}" for n in NAMES)]
    good = [True] * 6
    for r, v in enumerate(VALS):
        expect = (v | (v << 16)) & 0xFFFFFFFF
        expect4 = (v << 16) & 0xFFFFFFFF
        row = []
        for i, o in enumerate(outs):
            w = int(o[0, r, 0]) & 0xFFFFFFFF
            ok = w == (expect4 if i == 4 else expect)
            good[i] &= ok
            row.append("ok" if ok else f"x{w:08x}")
        lines.append(f"{v:>7} " + " ".join(f"{c:>14}" for c in row))
    lines.append("ALL-CORRECT variants: "
                 + str([n for n, g in zip(NAMES, good) if g] or "NONE"))
    return lines, good.count(False)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print("device:", torch.cuda.get_device_name(dev) if dev.type == "cuda"
          else "cpu (plain versions)")
    lines, nbad = run(dev)
    print("\n".join(lines))
    return 1 if nbad else 0


if __name__ == "__main__":
    sys.exit(main())
