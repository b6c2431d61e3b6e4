"""Times every variant of the ball-query kernel (``csrc/ballquery.cu``) at
the five ball-query sites of one flagship forward, B=2, on seeded
room-scale points, for both entry points (first-k and pack), at the
first site once more with a radius that hits nothing (the scan alone, so
that what the first-k pays for its hits can be read off), and above
nsample 256: sa1's shape at radius 0.4 with nsample 512 and 1024, and
MaskVoteNet's aggregation (one query a scene, radius 5 m, nsample 512).

A variant is (queries per warp, query warps, ranges, chunk points), or
with ranges 0 the ordered scan's; every variant that takes a call (the
ordered scan no pack, the ranges no nsample above 256) runs.  Each is held
against the variant the wrapper chooses for that shape (indices, words and
counts equal or the probe fails) and timed on the device: the variants are
separate kernels, so one profiler trace of a loop over all of them gives
each one's own time by name.  The table is what ``kernels/ballquery.py``
``_BY_SIZE`` was chosen from.

Run:  python -m scan2cap_torch.probes.bq_variants      (needs the card)
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List

import numpy as np
import torch

from scan2cap_torch.device import resolve_device
from scan2cap_torch.kernels import _build
from scan2cap_torch.kernels.ballquery import (VARIANTS, ball_query_cuda,
                                              ball_query_pack_cuda,
                                              bq_variant, kernel_of_name,
                                              takes)
from scan2cap_torch.ops.grouping import radius_squared
from scan2cap_torch.probes.timing import profile_calls

# (name, N, M, radius, nsample)
SITES = (("sa1", 40000, 2048, 0.2, 64), ("sa2", 2048, 1024, 0.4, 32),
         ("sa3", 1024, 512, 0.8, 16), ("sa4", 512, 256, 1.2, 16),
         ("vote_aggregation", 1024, 256, 0.3, 16),
         ("sa1_no_hits", 40000, 2048, 0.0001, 64),
         ("sa1_nsample512", 40000, 2048, 0.4, 512),
         ("sa1_nsample1024", 40000, 2048, 0.4, 1024),
         ("mvn_aggregation", 1024, 1, 5.0, 512))


def room(rs: np.random.RandomState, batch: int, n: int) -> np.ndarray:
    """A floor layer plus box-shaped objects, 8 m across."""
    xyz = np.zeros((batch, n, 3), np.float32)
    xyz[:, :, :2] = rs.uniform(-4, 4, (batch, n, 2))
    xyz[:, :, 2] = rs.uniform(0, 0.05, (batch, n))
    half = n // 2
    centers = rs.uniform(-3, 3, (batch, 8, 3))
    centers[..., 2] = 0.6
    obj = rs.randint(0, 8, (batch, half))
    xyz[:, :half] = (np.take_along_axis(centers, obj[..., None], 1)
                     + rs.uniform(-0.5, 0.5, (batch, half, 3)))
    return xyz


def run(device: str | torch.device = "cuda", batch: int = 2, sites=SITES,
        seed: int = 0, iters: int = 10) -> List[Dict]:
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the ball-query variants exist on the card only")
    rs = np.random.RandomState(seed)
    rows = []
    for name, n, m, radius, nsample in sites:
        pts = room(rs, batch, n)
        # queries as the model has them: a subset of the points
        pick = rs.choice(n, m, replace=False)
        xyz = torch.from_numpy(pts).to(dev)
        new_xyz = torch.from_numpy(np.ascontiguousarray(pts[:, pick])).to(dev)
        r2 = radius_squared(radius)
        chosen = bq_variant(n, m, nsample)
        want = ball_query_cuda(xyz, new_xyz, r2, nsample)
        want_words, want_counts = ball_query_pack_cuda(xyz, new_xyz, r2)
        # the (variant, pack) kernels that take this site's calls
        runs = [(v, pack) for v in range(len(VARIANTS)) for pack in
                (False, True) if takes(v, nsample, pack)]
        site_rows = []
        for v, shape in enumerate(VARIANTS):
            row = dict(site=name, n=n, m=m, nsample=nsample,
                       variant=list(shape), chosen=v == chosen)
            if (v, False) in runs:
                got = ball_query_cuda(xyz, new_xyz, r2, nsample, variant=v)
                row["equal"] = bool(torch.equal(got, want))
            if (v, True) in runs:
                words, counts = ball_query_pack_cuda(xyz, new_xyz, r2,
                                                     variant=v)
                row["pack_equal"] = bool(
                    torch.equal(words.view(torch.int32),
                                want_words.view(torch.int32))
                    and torch.equal(counts, want_counts))
            torch.cuda.synchronize()
            site_rows.append(row)

        def all_variants():
            for v, pack in runs:
                if pack:
                    ball_query_pack_cuda(xyz, new_xyz, r2, variant=v)
                else:
                    ball_query_cuda(xyz, new_xyz, r2, nsample, variant=v)

        def whole(trace):
            return sum(c for _, _, c in trace) == len(runs) * iters

        trace = profile_calls(all_variants, calls=iters, complete=whole)
        if not trace["complete"]:
            raise RuntimeError(f"site {name}: the profiler's trace holds "
                               f"{sum(c for _, _, c in trace['rows'])} "
                               f"kernels, not {len(runs) * iters}")
        for v, row in enumerate(site_rows):
            for key, pack in (("device_ms", False), ("pack_device_ms", True)):
                if (v, pack) in runs:
                    row[key] = sum(ms for ms, kname, _ in trace["rows"]
                                   if kernel_of_name(kname) == (v, pack)
                                   ) / iters
        rows += site_rows
    return rows


def resources() -> Dict[str, Dict]:
    """Registers and spill bytes per (variant, pack) kernel from this
    build's log (empty when an earlier process built the library)."""
    logs = _build.build_all(["ballquery"])
    return {kernel_of_name(k["name"]): k
            for k in _build.kernel_resources(logs["ballquery"])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--json", metavar="PATH",
                    help="write the rows there as JSON (default: print them "
                         "as the last line)")
    args = ap.parse_args(argv)
    built = resources()
    rows = run("cuda", args.batch)
    print(torch.cuda.get_device_name(0))
    bad = 0
    for r in rows:
        mark = "*" if r["chosen"] else " "
        v = VARIANTS.index(tuple(r["variant"]))
        regs = []
        for pack in (False, True):
            k = built.get((v, pack), {})
            regs.append(f"{k.get('registers', '?')}r/"
                        f"{k.get('spill_stores', 0) + k.get('spill_loads', 0)}s")
            r["pack_resources" if pack else "resources"] = k
        ok = r.get("equal", True) and r.get("pack_equal", True)

        def ms(key):
            return f"{r[key]:8.4f} ms" if key in r else "       --   "
        print(f"{r['site']:>17} N={r['n']:<6}{mark}{str(r['variant']):<18} "
              f"first-k {ms('device_ms')} ({regs[0]})  "
              f"pack {ms('pack_device_ms')} ({regs[1]})  "
              f"{'equal' if ok else 'DIFFERS'}")
        bad += not ok
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"bq_variants": rows}, f)
    else:
        print(json.dumps({"bq_variants": rows}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
