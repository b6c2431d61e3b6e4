"""Times FPS and the first-k ball query above the main path's shapes, in the
kernels of any checkout of this repository, so that two designs can be set
side by side on one card, one after the other in one command.

Sites (inputs made here from fixed seeds, the same for every checkout):
  * FPS of 2,048 picks from rooms of 100,000, 150,000 and 200,000 points,
    B=2;
  * the first-k at MaskVoteNet's vote aggregation (16 scenes of 1,024
    votes, one query a scene, radius 5 m, nsample 512), and at sa1's shape
    (B=2, 2,048 queries over 40,000 points, radius 0.4) with nsample 512
    and 1024.
For each: the kernel's own time on the device (profiler), the time by CUDA
events around back-to-back calls, the variant, and for FPS the device time
of one step.  Each result is checked against the same checkout's plain
version once.

Run from any directory:
  python scan2cap_torch/probes/large_shapes.py [--root CHECKOUT] [--json PATH]
``--root`` names the checkout whose ``scan2cap_torch`` is timed (default:
the one this file lies in).  Needs the card.  The runner is
``checkout.py``.
"""

from __future__ import annotations

import sys

if __package__:
    from scan2cap_torch.probes import checkout
else:           # run as a file, before --root's package is imported
    import checkout

# (name, N, npoint) and (name, B, N, M, radius, nsample)
FPS_SITES = (("room_100000", 100000, 2048), ("room_150000", 150000, 2048),
             ("room_200000", 200000, 2048))
FIRST_K_SITES = (("mvn_aggregation", 16, 1024, 1, 5.0, 512),
                 ("sa1_nsample512", 2, 40000, 2048, 0.4, 512),
                 ("sa1_nsample1024", 2, 40000, 2048, 0.4, 1024))


def room(np, rs, batch, n):
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


def run():
    import numpy as np
    import torch

    from scan2cap_torch.kernels import (ball_query_cuda, ballquery, fps,
                                        furthest_point_sample_cuda)
    from scan2cap_torch.ops.grouping import ball_query_plain, radius_squared
    from scan2cap_torch.ops.sampling import furthest_point_sample_plain
    from scan2cap_torch.probes.timing import device_ms, event_ms

    dev = torch.device("cuda")
    rows = []
    for i, (name, n, npoint) in enumerate(FPS_SITES):
        x = torch.from_numpy(room(np, np.random.RandomState(10 + i), 2,
                                  n)).to(dev)

        def call():
            return furthest_point_sample_cuda(x, npoint)

        equal = bool(torch.equal(call(), furthest_point_sample_plain(
            x, npoint)))
        dms = device_ms(call, 5)["ms"]
        rows.append(dict(kernel="fps", site=name, shape=[2, n, npoint],
                         variant=list(fps.VARIANTS[fps.fps_variant(n)]),
                         device_ms=dms, ms=event_ms(call, 5),
                         us_per_step=dms * 1e3 / (npoint - 1), equal=equal))
    for i, (name, B, n, m, r, s) in enumerate(FIRST_K_SITES):
        rs = np.random.RandomState(20 + i)
        if m == 1:       # rooms of 7 to 16 m, one query a scene
            half = np.linspace(3.5, 8.0, B)[:, None, None]
            pts = (rs.uniform(-1, 1, (B, n, 3)) * half
                   * np.float32([1, 1, 0.2])).astype(np.float32)
            q = pts[:, :1].copy()
        else:
            pts = room(np, rs, B, n)
            q = np.ascontiguousarray(pts[:, rs.choice(n, m, replace=False)])
        pts, q = torch.from_numpy(pts).to(dev), torch.from_numpy(q).to(dev)
        r2 = radius_squared(r)

        def call():
            return ball_query_cuda(pts, q, r2, s)

        equal = bool(torch.equal(call(), ball_query_plain(pts, q, r, s)))
        v = ballquery.bq_variant(n, m, s)
        rows.append(dict(kernel="first_k", site=name, shape=[B, n, m, s],
                         radius=r, variant=list(ballquery.VARIANTS[v]),
                         device_ms=device_ms(call, 20)["ms"],
                         ms=event_ms(call, 20), equal=equal))
    return dict(rows=rows)


def show(r) -> str:
    return (f"{r['kernel']:>8} {r['site']:>16} {str(r['variant']):<18} "
            f"dev {r['device_ms']:8.4f} ms  events {r['ms']:8.4f} ms  "
            f"{'equal' if r['equal'] else 'DIFFERS'}")


if __name__ == "__main__":
    sys.exit(checkout.main(__file__, __doc__, run, show))
