"""Pack-exactness probe (counterpart of ``scripts/micro_mxu_pack_probe.py``).

Feeds crafted 0/1 hit tiles through the (256, 512) @ (512, 48) pack product
and reads both the raw float32 product and the word ``lo | (hi << 16)``
made from it, so that a wrong word can be laid at the product or at the
integer post-chain.  Row r of the tile carries the bit pattern ``VALS[r]``
in both the low half (points 0..15 of word 0) and the high half (points
16..31).  The same patterns also go through the production ball-query
pack kernel as geometry (a point at the query where the bit is set, far
away where it is not), whose first word must be the same.

Run:  python -m scan2cap_torch.probes.pack        (exit 1 on a wrong row)
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Tuple

import numpy as np
import torch

from scan2cap_torch.device import resolve_device
from scan2cap_torch.kernels.ballquery import ball_query_pack_cuda
from scan2cap_torch.kernels.pack_probe import MQ, NC, OUT, pack_probe_cuda
from scan2cap_torch.ops.grouping import ball_query_pack_plain, radius_squared

VALS = (1, 2, 4, 64, 127, 128, 129, 255, 256, 257, 520, 4096,
        32768, 32769, 65535)


def pack_matrix(device: str | torch.device = "cpu") -> torch.Tensor:
    """(NC, 48) float32: columns [0:16) word low halves, [16:32) high
    halves, [32:48) per-word popcount weights; every entry a power of two,
    one or zero (copy of ``scan2cap_tpu/ops/pallas/ballquery.py:42-55``)."""
    n = torch.arange(NC, device=device)[:, None]
    k = torch.arange(48, device=device)[None, :]
    word, bit = n // 32, n % 32
    lo = (k == word) & (bit < 16)
    hi = (k == 16 + word) & (bit >= 16)
    cnt = k == 32 + word
    zero = torch.zeros((), dtype=torch.float32, device=device)
    weight = torch.where(lo, torch.pow(2.0, bit % 16).float(), zero)
    weight = torch.where(hi, torch.pow(2.0, bit - 16).float(), weight)
    return torch.where(cnt, torch.ones_like(weight), weight)


def half_words(hit: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """hit (1, MQ, NC) -> the float32 product (MQ, 48) and its low and high
    half-word columns converted to int32 (truncation, as ``astype``)."""
    packed = torch.matmul(hit[0].to(torch.float32), pack_matrix(hit.device))
    return (packed, packed[:, 0:16].to(torch.int32),
            packed[:, 16:32].to(torch.int32))


def pad_columns(x: torch.Tensor) -> torch.Tensor:
    """(MQ, w) -> (1, MQ, OUT) with zeros past column w."""
    return torch.nn.functional.pad(x, (0, OUT - x.shape[-1]))[None]


def pack_probe_plain(hit: torch.Tensor):
    """Plain PyTorch version of the probe kernel: raw (1, MQ, 128) float32,
    word (1, MQ, 128) int32."""
    packed, lo, hi = half_words(hit)
    return pad_columns(packed), pad_columns(lo | (hi << 16))


def pack_probe(hit: torch.Tensor):
    """The probe on ``hit``'s device: the kernel on a CUDA tensor (or an
    error), the plain version on a CPU tensor."""
    if hit.is_cuda:
        return pack_probe_cuda(hit.contiguous())
    if hit.device.type != "cpu":
        raise ValueError(f"unsupported device {hit.device}")
    return pack_probe_plain(hit)


def crafted_hits(vals=VALS) -> np.ndarray:
    """(1, MQ, NC) float32 0/1 tile: row r holds ``vals[r]`` in both halves
    of word 0."""
    hit = np.zeros((1, MQ, NC), np.float32)
    for r, v in enumerate(vals):
        for b in range(16):
            if (v >> b) & 1:
                hit[0, r, b] = 1.0
                hit[0, r, 16 + b] = 1.0
    return hit


def production_words(hit: torch.Tensor) -> torch.Tensor:
    """The tile's hit pattern as geometry through the production pack
    (``ball_query_pack``): word 0 of each row, (MQ,) int64."""
    pts = torch.where(hit[0, :, :, None] > 0, 0.0, 100.0).expand(-1, -1, 3)
    pts = pts.contiguous()                                    # (MQ, NC, 3)
    query = torch.zeros((MQ, 1, 3), dtype=torch.float32, device=hit.device)
    pack = ball_query_pack_cuda if hit.is_cuda else ball_query_pack_plain
    words, _ = pack(pts, query, radius_squared(0.2))
    return words[:, 0, 0].to(torch.int64) & 0xFFFFFFFF


def run(device: str | torch.device = "cuda") -> Tuple[List[str], int]:
    """Run the probe on ``device``; returns the table's lines and the
    number of wrong rows."""
    dev = resolve_device(device)
    hit = torch.from_numpy(crafted_hits()).to(dev)
    raw, word = (x.cpu().numpy() for x in pack_probe(hit))
    prod = production_words(hit).cpu().numpy()
    lines = [f"{'target':>7} {'raw_lo':>9} {'raw_hi':>9} {'raw_cnt':>8} "
             f"{'word':>12} {'prod_word':>12} {'expect_word':>12}"]
    nbad = 0
    for r, v in enumerate(VALS):
        expect = (v | (v << 16)) & 0xFFFFFFFF
        w = int(word[0, r, 0]) & 0xFFFFFFFF
        ok = w == expect and int(prod[r]) == expect
        nbad += 0 if ok else 1
        lines.append(f"{v:>7} {raw[0, r, 0]:>9.1f} {raw[0, r, 16]:>9.1f} "
                     f"{raw[0, r, 32]:>8.1f} {w:>12} {int(prod[r]):>12} "
                     f"{expect:>12}  {'ok' if ok else '<-- WRONG'}")
    lines.append(f"wrong rows: {nbad}/{len(VALS)}")
    stray = max(np.abs(raw[0, :len(VALS), 1:16]).max(),
                np.abs(raw[0, :len(VALS), 17:32]).max())
    lines.append(f"stray mass in other word columns: {float(stray)}")
    return lines, nbad + (1 if stray != 0 else 0)


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
