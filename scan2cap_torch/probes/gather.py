"""Row-gather timing probe (counterpart of ``scripts/micro_vmem_gather.py``).

Times the hand-written gather kernel against ``torch.gather`` at the sa1
neighbour-gather shape, one scene: 2048 x 64 = 131,072 row reads of a
(40960, 64) float32 table, and checks that both give the same rows.  Each
is timed twice: with CUDA events around back-to-back calls (which includes
what a call costs on the host) and from a profiler trace of the same loop
(the kernel's own time on the device; the ns-per-row figure is that one).

Run:  python -m scan2cap_torch.probes.gather
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict

import torch

from scan2cap_torch.device import resolve_device
from scan2cap_torch.ops.grouping import (group_points_forward,
                                         group_points_plain)
from scan2cap_torch.probes.timing import device_ms, event_ms

N, C = 40960, 64
M, S = 2048, 64
ROWS = M * S


def run(device: str | torch.device = "cuda", iters: int = 50,
        n: int = N, m: int = M, seed: int = 0) -> Dict:
    """Gather ``m * S`` rows of an ``(n, C)`` table on ``device``; on the
    card also the kernel's and ``torch.gather``'s time per scene-gather."""
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    table = torch.randn((1, n, C), generator=g).to(dev)
    idx = torch.randint(0, n, (1, m, S), generator=g, dtype=torch.int32).to(dev)
    got = group_points_forward(table, idx)
    want = group_points_plain(table, idx)
    report = dict(rows=m * S, table=[n, C], equal=bool(torch.equal(got, want)))
    if dev.type == "cuda":
        def kernel():
            return group_points_forward(table, idx)

        def library():
            return group_points_plain(table, idx)

        ms, lib = event_ms(kernel, iters), event_ms(library, iters)
        dms = device_ms(kernel, iters)["ms"]
        dlib = device_ms(library, iters)["ms"]
        report.update(kernel_ms=ms, torch_gather_ms=lib,
                      kernel_device_ms=dms, torch_gather_device_ms=dlib,
                      kernel_ns_per_row=dms * 1e6 / (m * S),
                      torch_gather_ns_per_row=dlib * 1e6 / (m * S),
                      device=torch.cuda.get_device_name(dev))
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    r = run(args.device, args.iters)
    if "kernel_ms" in r:
        print(f"{r['device']}: {r['rows']} rows of a {tuple(r['table'])} "
              f"float32 table")
        print(f"torch.gather  : {r['torch_gather_device_ms']:.4f} ms on the "
              f"device per scene-gather ({r['torch_gather_ns_per_row']:.3f} "
              f"ns/row), {r['torch_gather_ms']:.4f} ms per call by events")
        print(f"gather kernel : {r['kernel_device_ms']:.4f} ms on the "
              f"device per scene-gather ({r['kernel_ns_per_row']:.3f} "
              f"ns/row), {r['kernel_ms']:.4f} ms per call by events")
    else:
        print(f"cpu (plain version only, no timing): {r['rows']} rows")
    print("rows equal:", r["equal"])
    return 0 if r["equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
