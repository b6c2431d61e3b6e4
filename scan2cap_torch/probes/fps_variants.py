"""Times every variant of the FPS kernel (``csrc/fps.cu``) at the five FPS
sites of one flagship forward and at scenes above what 8 blocks' registers
hold (100,000, 150,000, 200,000 and 400,001 points), B=2, on seeded
room-scale points.

A variant is (cluster size, threads per block, points per thread in
registers, most points per thread in shared memory); every
variant that holds a site's N is run, held against the variant the wrapper
chooses for that N (indices equal or the probe fails), and timed with CUDA
events.  The table is what ``kernels/fps.py`` ``_BY_SIZE`` was chosen from.

Run:  python -m scan2cap_torch.probes.fps_variants      (needs the card)
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List

import numpy as np
import torch

from scan2cap_torch.device import resolve_device
from scan2cap_torch.kernels.fps import (VARIANTS, fps_variant,
                                        furthest_point_sample_cuda,
                                        variant_points)
from scan2cap_torch.probes.timing import event_ms

SITES = (("sa1", 40000, 2048), ("sa2", 2048, 1024), ("sa3", 1024, 512),
         ("sa4", 512, 256), ("vote_aggregation", 1024, 256),
         ("large", 100000, 2048), ("large", 150000, 2048),
         ("large", 200000, 2048), ("large", 400001, 256))


def run(device: str | torch.device = "cuda", batch: int = 2,
        sites=SITES, seed: int = 0) -> List[Dict]:
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the FPS variants exist on the card only")
    rs = np.random.RandomState(seed)
    rows = []
    for name, n, npoint in sites:
        xyz = torch.from_numpy(
            rs.uniform(-4, 4, (batch, n, 3)).astype(np.float32)).to(dev)
        chosen = fps_variant(n)
        want = furthest_point_sample_cuda(xyz, npoint)
        for v, shape in enumerate(VARIANTS):
            if (variant_points(v) or n) < n:       # None: any N
                continue
            row = dict(site=name, n=n, npoint=npoint, variant=list(shape),
                       chosen=v == chosen)
            try:
                got = furthest_point_sample_cuda(xyz, npoint, variant=v)
                torch.cuda.synchronize()
            except RuntimeError as e:          # a launch the card refuses
                row.update(error=str(e))
                rows.append(row)
                continue
            row["equal"] = bool(torch.equal(got, want))
            ms = event_ms(
                lambda: furthest_point_sample_cuda(xyz, npoint, variant=v),
                iters=3 if n > 10000 else 10)
            row.update(ms=ms, us_per_step=ms * 1e3 / (npoint - 1))
            rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=2)
    args = ap.parse_args(argv)
    rows = run("cuda", args.batch)
    print(torch.cuda.get_device_name(0))
    bad = 0
    for r in rows:
        mark = "*" if r["chosen"] else " "
        if "error" in r:
            print(f"{r['site']:>17} N={r['n']:<6}{mark}{str(r['variant']):<18} "
                  f"{r['error']}")
            bad += r["chosen"]
            continue
        print(f"{r['site']:>17} N={r['n']:<6}{mark}{str(r['variant']):<18} "
              f"{r['ms']:8.4f} ms  {r['us_per_step']:6.3f} us/step  "
              f"{'equal' if r['equal'] else 'DIFFERS'}")
        bad += not r["equal"]
    print(json.dumps({"fps_variants": rows}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
