#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``scan2cap_torch``) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit, no result printed):
  1. card name and power limit (nvidia-smi); no CUDA -> exit 1;
  2. build the CUDA kernels (one nvcc per source, in parallel);
  3. each kernel against its plain PyTorch version on the card, at the
     main-path shapes (B=2) plus edge cases: FPS (every boundary between
     its variants, scenes smaller than a cluster, ties and padding across
     the blocks of a cluster, ten clusters in flight, the largest scene),
     ball query, fused and pack (every boundary between its variants, N no
     multiple of a word, of 4 or of a chunk, hits that end and start a
     range, padding from a later range, points on the radius at range and
     chunk ends, the largest nsample, ten scenes of 40,000 points, views
     off a 16-byte boundary), the row gather at its six sites (odd and
     even widths, views off a 16-byte boundary, a ragged row count), and
     the two pack-tile probes; indices, words, counts and gathered rows
     must be equal; kernel, plain and library-call times and the bound at
     those shapes, and the kernels' own time on the device from a profiler
     trace beside the event time;
  4. serve the flagship CapNet (135 input channels over 40,000 points, 256
     proposals, hidden 512, vocabulary 3,433) with seeded random weights
     through ``make_eval_step`` (detection loss on): launch counts per
     forward (the wrappers' counts, and as many FPS kernels in a profiler
     trace of one request), ms per batch (median of three timed spans of 30
     requests, with the spread), and the same weights and batch through the
     port on the CPU as the reference (indices exact, corners within 1e-3,
     tokens >= 99% equal);
  5. train the same model through ``make_train_step`` on a repeated batch:
     launch counts per step, ms per step (median of three timed spans),
     stage times, and step 1's loss and per-tensor gradient norms against
     the port on the CPU (loss 1e-3, norms 1e-2 relative); the loss must be
     finite and fall;
  6. the probes' entry points (``scan2cap_torch.probes``): every row right;
  7. the JSON lines: kernels, serving, training, and last the device line.
Launch counts are set to 0 just before each of the paths 4-6 and read just
after.  ``--kernels-only`` stops after phase 3 (a short first check of a
new kernel).  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, dense): float32 outside the
# tensor cores and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# float operations per point tested: 3 sub, 1 mul, 2 fma (2 each), and the
# running min (FPS) or the compare (ball query)
FPS_OPS_PER_POINT = 9
BQ_OPS_PER_PAIR = 9
# what an exact all-pairs hit test issues per 32 pairs (3 sub, 1 mul, 2 fma,
# the compare, the ballot), and the warp schedulers that issue one
# instruction a clock each (132 SMs x 4)
BQ_ISSUE_SLOTS_PER_WARP_STEP = 8
WARP_SCHEDULERS = 132 * 4

# (name, N, npoint) of the five FPS sites and (N, M, radius, nsample) of the
# five ball-query sites of one flagship forward
FPS_SITES = (("sa1", 40000, 2048), ("sa2", 2048, 1024), ("sa3", 1024, 512),
             ("sa4", 512, 256), ("vote_aggregation", 1024, 256))
BQ_SITES = (("sa1", 40000, 2048, 0.2, 64), ("sa2", 2048, 1024, 0.4, 32),
            ("sa3", 1024, 512, 0.8, 16), ("sa4", 512, 256, 1.2, 16),
            ("vote_aggregation", 1024, 256, 0.3, 16))
# (name, N, C, M, S) of the row gather: the five grouping sites of a
# forward (the gather-lean layers gather their layer-0 projection) and the
# sa1 backward's gather of the raw 3 + 135 channels
GATHER_SITES = (("sa1", 40000, 64, 2048, 64),
                ("sa1_backward", 40000, 138, 2048, 64),
                ("sa2", 2048, 128, 1024, 32), ("sa3", 1024, 128, 512, 16),
                ("sa4", 512, 128, 256, 16),
                ("vote_aggregation", 1024, 128, 256, 16))
NUM_VOCABS = 3433
TRAIN_LOSSES = dict(detection=True, caption=True, orientation=True,
                    distance=False)


class PhaseError(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise PhaseError(msg)


def bound_ms(nbytes, ops):
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def issue_floor_ms(pairs_tested, sm_clock_mhz):
    """The least time an exact all-pairs ball query of so many pairs can
    take on the card: its instructions over what the schedulers issue at
    the largest SM clock."""
    return (pairs_tested / 32 * BQ_ISSUE_SLOTS_PER_WARP_STEP
            / (WARP_SCHEDULERS * sm_clock_mhz * 1e6) * 1e3)


def cuda_ms(torch, fn, iters, warmup=1):
    """Mean time of fn() over iters back-to-back launches (CUDA events): the
    larger of the host's cost per call and the device's time."""
    from scan2cap_torch.probes.timing import event_ms
    return event_ms(fn, iters, warmup)


def device_only_ms(fn, iters):
    """The kernels' own time per call of fn(), from a profiler trace."""
    from scan2cap_torch.probes.timing import device_ms
    r = device_ms(fn, iters)
    require(r["complete"], f"the profiler's trace holds {r['launches']} "
            f"kernels per call after {r['attempts']} passes")
    return r["ms"]


# --------------------------------------------------------------------- phase 3
def check_fps_edges(torch):
    """Every FPS edge case: the kernel's indices equal the plain version's,
    or the run fails; a scene above the limit is refused."""
    from scan2cap_torch.kernels import furthest_point_sample_cuda
    from scan2cap_torch.kernels.fps import fps_max_points
    from scan2cap_torch.ops.sampling import furthest_point_sample_plain
    from scan2cap_torch.probes.cases import FPS_EDGE_CASES, fps_edge_case

    dev = torch.device("cuda")
    for name in FPS_EDGE_CASES:
        x, npoint, variant = fps_edge_case(name)
        xt = torch.from_numpy(x).to(dev)
        got = furthest_point_sample_cuda(xt, npoint, variant=variant)
        want = furthest_point_sample_plain(xt, npoint)
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"fps edge case {name}: kernel != plain")
        if name.startswith("all_invalid"):
            require(bool((got[1] == 0).all()), "all-invalid scene must give 0s")
    most = fps_max_points()
    try:
        furthest_point_sample_cuda(torch.zeros((1, most + 1, 3), device=dev), 4)
    except ValueError:
        pass
    else:
        raise PhaseError(f"fps took N={most + 1}, above its limit {most}")
    return len(FPS_EDGE_CASES)


def check_bq_edges(torch):
    """Every ball-query edge case through both entry points: indices, words
    and counts equal the plain versions', or the run fails; an nsample above
    the wrapper's limit is refused."""
    from scan2cap_torch.kernels import ball_query_cuda, ball_query_pack_cuda
    from scan2cap_torch.kernels.ballquery import BQ_MAX_NSAMPLE
    from scan2cap_torch.ops.grouping import (ball_query_pack_plain,
                                             ball_query_plain, radius_squared)
    from scan2cap_torch.probes.cases import (BQ_EDGE_CASES, bq_edge_case,
                                             offset_view)

    dev = torch.device("cuda")
    for name in BQ_EDGE_CASES:
        pts, q, r, s, variant, offset = bq_edge_case(name)
        p_t = offset_view(pts, offset, dev)
        q_t = torch.from_numpy(q).to(dev)
        r2 = radius_squared(r)
        got = ball_query_cuda(p_t, q_t, r2, s, variant=variant)
        want = ball_query_plain(p_t, q_t, r, s)
        wk, ck = ball_query_pack_cuda(p_t, q_t, r2, variant=variant)
        wp, cp = ball_query_pack_plain(p_t, q_t, r2)
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"ball_query edge case {name}")
        require(torch.equal(wk.view(torch.int32), wp.view(torch.int32))
                and torch.equal(ck, cp), f"ball_query_pack edge case {name}")
    x = torch.zeros((1, 64, 3), device=dev)
    try:
        ball_query_cuda(x, x, 0.04, BQ_MAX_NSAMPLE + 1)
    except ValueError:
        pass
    else:
        raise PhaseError(f"ball query took nsample={BQ_MAX_NSAMPLE + 1}, "
                         f"above its limit {BQ_MAX_NSAMPLE}")
    return len(BQ_EDGE_CASES)


def check_kernels(torch, np, sm_clock_mhz):
    from scan2cap_torch.kernels import (ball_query_cuda, ball_query_pack_cuda,
                                        furthest_point_sample_cuda)
    from scan2cap_torch.kernels import ballquery
    from scan2cap_torch.kernels.fps import VARIANTS, fps_variant
    from scan2cap_torch.ops.grouping import (ball_query_pack_plain,
                                             ball_query_plain, radius_squared)
    from scan2cap_torch.ops.sampling import furthest_point_sample_plain
    from scan2cap_torch.probes.bq_variants import room

    dev = torch.device("cuda")
    B = 2

    print(f"fps edge cases: {check_fps_edges(torch)} exact", flush=True)

    print(f"ball query edge cases: {check_bq_edges(torch)} exact, both "
          f"entry points", flush=True)

    # -- the five main-path sites, with inputs chained as the forward does
    xyz0 = torch.from_numpy(room(np.random.RandomState(1), B, 40000)).to(dev)
    fps_in, bq_in = {}, {}
    cur = xyz0
    for name, N, npoint in FPS_SITES[:4]:
        require(cur.shape[1] == N, f"site {name}: N={cur.shape[1]} != {N}")
        fps_in[name] = cur
        inds = furthest_point_sample_plain(cur, npoint).long()
        nxt = torch.gather(cur, 1, inds[..., None].expand(-1, -1, 3)).contiguous()
        bq_in[name] = (cur, nxt)
        cur = nxt
    g = torch.Generator().manual_seed(5)
    seeds = bq_in["sa2"][1]               # the 1024 seed points (sa2's output)
    votes = (seeds + 0.1 * torch.randn(
        seeds.shape, generator=g).to(dev)).contiguous()
    fps_in["vote_aggregation"] = votes
    vinds = furthest_point_sample_plain(votes, FPS_SITES[4][2]).long()
    bq_in["vote_aggregation"] = (
        votes, torch.gather(votes, 1, vinds[..., None].expand(-1, -1, 3))
        .contiguous())

    fps_sites, bq_sites, pack_sites = [], [], []
    bq_idx = {}
    for name, N, npoint in FPS_SITES:
        x = fps_in[name]
        require(x.shape[1] == N, f"fps site {name}: N={x.shape[1]} != {N}")
        got = furthest_point_sample_cuda(x, npoint)
        want = furthest_point_sample_plain(x, npoint)
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"fps site {name}: kernel != plain")
        iters = 5 if N > 10000 else 20
        ms = cuda_ms(torch, lambda: furthest_point_sample_cuda(x, npoint),
                     iters=iters)
        dms = device_only_ms(lambda: furthest_point_sample_cuda(x, npoint),
                             iters)
        pms = cuda_ms(torch, lambda: furthest_point_sample_plain(x, npoint),
                      iters=1)
        b_ms, by = bound_ms(B * N * 12 + B * npoint * 4,
                            B * (npoint - 1) * N * FPS_OPS_PER_POINT)
        fps_sites.append(dict(site=name, shape=[B, N, npoint], ms=ms,
                              device_ms=dms,
                              us_per_step=ms * 1e3 / (npoint - 1),
                              variant=list(VARIANTS[fps_variant(N)]),
                              plain_ms=pms, bound_ms=b_ms, bound_by=by,
                              max_abs_err=int((got - want).abs().max())))

    for name, N, M, r, s in BQ_SITES:
        pts, q = bq_in[name]
        require(tuple(q.shape) == (B, M, 3) and pts.shape[1] == N,
                f"bq site {name}: {q.shape} {pts.shape}")
        r2 = radius_squared(r)
        got = ball_query_cuda(pts, q, r2, s)
        want = ball_query_plain(pts, q, r, s)
        wk, ck = ball_query_pack_cuda(pts, q, r2)
        wp, cp = ball_query_pack_plain(pts, q, r2)
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"ball_query site {name}: kernel != plain")
        bq_idx[name] = want
        require(torch.equal(wk.view(torch.int32), wp.view(torch.int32))
                and torch.equal(ck, cp), f"ball_query_pack site {name}")
        # work this data needs: a query stops at its nsample-th hit
        total = cp.sum(-1)
        tested = torch.where(total >= s, want[..., -1].long() + 1,
                             torch.full_like(total, N).long())
        pairs = int(tested.sum())
        io = B * N * 12 + B * M * 12
        variant = list(ballquery.VARIANTS[ballquery.bq_variant(N, M, s)])

        ms = cuda_ms(torch, lambda: ball_query_cuda(pts, q, r2, s), iters=20)
        dms = device_only_ms(lambda: ball_query_cuda(pts, q, r2, s), 20)
        pms = cuda_ms(torch, lambda: ball_query_plain(pts, q, r, s), iters=2)
        b_ms, by = bound_ms(io + B * M * s * 4, pairs * BQ_OPS_PER_PAIR)
        bq_sites.append(dict(site=name, shape=[B, N, M, s], radius=r, ms=ms,
                             device_ms=dms, variant=variant,
                             plain_ms=pms, bound_ms=b_ms, bound_by=by,
                             pairs_tested=pairs,
                             issue_floor_ms=issue_floor_ms(pairs, sm_clock_mhz),
                             max_abs_err=int((got - want).abs().max())))
        W = wk.shape[-1]
        ms = cuda_ms(torch, lambda: ball_query_pack_cuda(pts, q, r2), iters=20)
        dms = device_only_ms(lambda: ball_query_pack_cuda(pts, q, r2), 20)
        pms = cuda_ms(torch, lambda: ball_query_pack_plain(pts, q, r2), iters=2)
        b_ms, by = bound_ms(io + B * M * W * 8, B * M * N * BQ_OPS_PER_PAIR)
        pack_sites.append(dict(site=name, shape=[B, N, M, W], ms=ms,
                               device_ms=dms, variant=variant,
                               plain_ms=pms, bound_ms=b_ms, bound_by=by,
                               pairs_tested=B * M * N,
                               issue_floor_ms=issue_floor_ms(B * M * N,
                                                             sm_clock_mhz),
                               max_abs_err=max(
                                   int((ck - cp).abs().max()),
                                   int((wk.view(torch.int32)
                                        != wp.view(torch.int32)).any()))))
    gather_sites = check_gather(torch, bq_idx)
    probe_sites = check_probes(torch, np)
    return fps_sites, bq_sites, pack_sites, gather_sites, probe_sites


def check_gather(torch, bq_idx):
    """The row gather against its plain version: edge cases, then the six
    sites with the ball query's own indices.  Exact or fail."""
    from scan2cap_torch.kernels import group_points_cuda
    from scan2cap_torch.kernels.gather import gather_vector_bytes
    from scan2cap_torch.ops.grouping import group_points_plain
    from scan2cap_torch.probes.cases import (GATHER_EDGE_CASES,
                                             gather_edge_case, gather_table)

    dev = torch.device("cuda")
    for name, shape in GATHER_EDGE_CASES.items():
        flat, idx, offset = gather_edge_case(name)
        f = gather_table(torch.from_numpy(flat).to(dev), shape[:3], offset)
        require(f.is_contiguous() and f.data_ptr() % 16 == 4 * offset,
                f"gather edge case {name}: the view lies at {f.data_ptr() % 16}")
        i = torch.from_numpy(idx).to(dev)
        got, want = group_points_cuda(f, i), group_points_plain(f, i)
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"gather edge case {name}")
        vec = gather_vector_bytes(shape[2], f.data_ptr(), got.data_ptr())
        require(f.data_ptr() % vec == 0 and (4 * shape[2]) % vec == 0,
                f"gather edge case {name}: {vec}-byte vectors do not fit")

    B = 2
    g = torch.Generator().manual_seed(7)
    sites = []
    for name, N, C, M, S in GATHER_SITES:
        idx = bq_idx[name.split("_backward")[0]]
        require(tuple(idx.shape) == (B, M, S), f"gather site {name}: {idx.shape}")
        feats = torch.randn((B, N, C), generator=g).to(dev)
        got, want = group_points_cuda(feats, idx), group_points_plain(feats, idx)
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"gather site {name}: kernel != plain")
        expand = idx.reshape(B, M * S).long()[..., None].expand(-1, -1, C)
        ms = cuda_ms(torch, lambda: group_points_cuda(feats, idx), iters=20)
        pms = cuda_ms(torch, lambda: group_points_plain(feats, idx), iters=20)
        lms = cuda_ms(torch, lambda: torch.gather(feats, 1, expand), iters=20)
        dms = device_only_ms(lambda: group_points_cuda(feats, idx), 20)
        dlms = device_only_ms(lambda: torch.gather(feats, 1, expand), 20)
        b_ms, by = bound_ms(B * N * C * 4 + B * M * S * 4 + B * M * S * C * 4, 0)
        sites.append(dict(site=name, shape=[B, N, C, M, S], ms=ms,
                          device_ms=dms, library_device_ms=dlms,
                          plain_ms=pms, library_ms=lms, bound_ms=b_ms,
                          bound_by=by,
                          max_abs_err=float((got - want).abs().max())))
    return sites


def check_probes(torch, np):
    """The two pack-tile probe kernels against their plain versions on
    crafted, random and all-ones tiles: every float and every word equal."""
    from scan2cap_torch.kernels import pack_probe_cuda, shift_probe_cuda
    from scan2cap_torch.probes import pack, shift

    dev = torch.device("cuda")
    rs = np.random.RandomState(5)
    tiles = [("crafted", pack.crafted_hits(), shift.crafted_ints()),
             ("random", (rs.rand(1, 256, 512) < 0.3).astype(np.float32),
              rs.randint(0, 65536, (1, 256, 128)).astype(np.int32)),
             ("all_ones", np.ones((1, 256, 512), np.float32),
              np.full((1, 256, 128), 65535, np.int32))]
    err = {"pack_probe": 0.0, "shift_probe": 0.0}
    for name, hit, ints in tiles:
        h, i = torch.from_numpy(hit).to(dev), torch.from_numpy(ints).to(dev)
        raw, word = pack_probe_cuda(h)
        praw, pword = pack.pack_probe_plain(h)
        outs, pouts = shift_probe_cuda(h, i), shift.shift_probe_plain(h, i)
        torch.cuda.synchronize()
        require(torch.equal(raw, praw) and torch.equal(word, pword),
                f"pack probe tile {name}: kernel != plain")
        for v, (a, b) in enumerate(zip(outs, pouts)):
            require(torch.equal(a, b), f"shift probe tile {name}: v{v} != plain")
        err["pack_probe"] = max(err["pack_probe"],
                                float((raw - praw).abs().max()),
                                float((word - pword).abs().max()))
        err["shift_probe"] = max([err["shift_probe"]] + [
            float((a - b).abs().max()) for a, b in zip(outs, pouts)])

    h = torch.from_numpy(tiles[1][1]).to(dev)
    i = torch.from_numpy(tiles[1][2]).to(dev)
    P = pack.pack_matrix(dev)

    def lib_pack():                      # one matmul plus the integer ops
        packed = torch.matmul(h[0], P)
        lo, hi = packed[:, :16].to(torch.int32), packed[:, 16:32].to(torch.int32)
        return packed, lo | (hi << 16)

    def lib_shift():
        packed = torch.matmul(h[0], P)
        lo, hi = packed[:, :16].to(torch.int32), packed[:, 16:32].to(torch.int32)
        return (lo | (hi << 16), lo | (hi * 65536), lo + (hi << 16),
                lo | ((hi << 8) << 8), i[0, :, :16] << 16, lo | (hi << 16))

    flops = 2 * 256 * 48 * 512
    tile, out = 256 * 512 * 4, 256 * 128 * 4
    sites = {}
    for name, kern, plain, lib, nbytes in (
            ("pack_probe", lambda: pack_probe_cuda(h),
             lambda: pack.pack_probe_plain(h), lib_pack, tile + 2 * out),
            ("shift_probe", lambda: shift_probe_cuda(h, i),
             lambda: shift.shift_probe_plain(h, i), lib_shift,
             tile + out + 6 * out)):
        b_ms, by = bound_ms(nbytes, flops)
        sites[name] = [dict(site="tile", shape=[1, 256, 512],
                            ms=cuda_ms(torch, kern, iters=50),
                            device_ms=device_only_ms(kern, 50),
                            plain_ms=cuda_ms(torch, plain, iters=50),
                            library_ms=cuda_ms(torch, lib, iters=50),
                            bound_ms=b_ms, bound_by=by,
                            max_abs_err=err[name])]
    return sites


def kernel_entry(name, source, replaces, sites, launches):
    """One entry of the ``kernels`` line: times summed over the sites;
    ``launches`` is the sum over the paths driven, ``launches_by_path`` the
    count of each (every path starts from counts of 0)."""
    b = sum(s["bound_ms"] for s in sites)
    by_ops = sum(s["bound_ms"] for s in sites if s["bound_by"] == "operations")
    lib = [s["library_ms"] for s in sites if s.get("library_ms") is not None]
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=(None if launches is None
                          else sum(launches.values())),
                launches_by_path=launches,
                max_abs_err=max(s["max_abs_err"] for s in sites),
                ms=sum(s["ms"] for s in sites),
                device_ms=(sum(s["device_ms"] for s in sites)
                           if all("device_ms" in s for s in sites) else None),
                plain_ms=sum(s["plain_ms"] for s in sites),
                bound_ms=b, bound_by="operations" if by_ops >= b / 2 else "bytes",
                library_ms=sum(lib) if len(lib) == len(sites) else None,
                sites=sites)


def profile_step(fn, what, keep=10):
    """One call of fn() under a fresh profiler, started on an idle card:
    the `keep` largest kernels by device time, the summed device time of
    all kernels (ms), the call's wall time (ms), the launches of the FPS
    kernel in the trace and the profiler passes it took.  The trace must hold as
    many FPS kernels as the wrapper launches per call (5)."""
    from scan2cap_torch.probes.timing import profile_calls

    def fps_launches(rows):
        return sum(c for _, n, c in rows if "fps_kernel" in n)

    r = profile_calls(fn, cpu=True, complete=lambda rows: fps_launches(rows) == 5)
    fps = fps_launches(r["rows"])
    require(r["complete"], f"the {what} trace holds {fps} FPS kernels after "
            f"{r['attempts']} passes, the wrapper counted 5 per call")
    rows = sorted(r["rows"], reverse=True)
    top = [dict(ms=t, name=n[:60], count=c) for t, n, c in rows[:keep]]
    return dict(top=top, kernel_ms=sum(t for t, _, _ in rows),
                profiled_wall_ms=r["wall_ms"], fps_kernels_in_trace=fps,
                kernels_in_trace=sum(c for _, _, c in rows),
                passes=r["attempts"])


# --------------------------------------------------------------------- phase 4
def flagship_batch(np, cfg, B):
    """The synthetic flagship batch (host arrays) and its vocabulary size:
    seeded normals and multiview features in place of the zeros."""
    from scan2cap_torch.data.synthetic import make_scene_batch, make_vocab
    vocab = make_vocab(num_vocabs=NUM_VOCABS, emb_size=cfg.emb_size)
    host = make_scene_batch(cfg, batch_size=B, num_objects=8, vocab=vocab,
                            seed=0)
    rs = np.random.RandomState(1)
    pc = host["point_clouds"]
    pc[..., 3:3 + 131] = rs.randn(B, cfg.num_points, 131).astype(np.float32) * 0.1
    require(pc.shape == (B, cfg.num_points, 135), f"flagship input {pc.shape}")
    return host


def serve_flagship(torch, np, requests=30, windows=3):
    from scan2cap_torch.config import flagship_config
    from scan2cap_torch.data.synthetic import to_device
    from scan2cap_torch.kernels import (WRAPPERS, ball_query_cuda,
                                        furthest_point_sample_cuda,
                                        group_points_cuda,
                                        reset_launch_counts)
    from scan2cap_torch.models import CapNet
    from scan2cap_torch.models.voting import l2_normalize_votes
    from scan2cap_torch.train.step import make_eval_step

    cfg = flagship_config()
    B = 2
    host = flagship_batch(np, cfg, B)
    pc = host["point_clouds"]

    model = CapNet(cfg, num_vocabs=NUM_VOCABS, device="cuda", seed=0)
    step = make_eval_step(cfg, model)
    batch = to_device(host, "cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    step(batch)                                          # first call
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3

    # `windows` spans of `requests` back-to-back requests, each span timed
    # whole on the host clock; the median span gives ms per batch
    reset_launch_counts()
    window_ms = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(requests):
            out = step(batch)
        torch.cuda.synchronize()
        window_ms.append((time.perf_counter() - t0) * 1e3 / requests)
    launches = {w.__name__: w.launches for w in WRAPPERS}
    served = requests * windows
    require(furthest_point_sample_cuda.launches == 5 * served,
            f"FPS launches {launches}, want 5 per forward")
    require(ball_query_cuda.launches == 5 * served,
            f"ball query launches {launches}, want 5 per forward")
    require(group_points_cuda.launches == 5 * served,
            f"gather launches {launches}, want 5 per forward")
    ms = sorted(window_ms)[len(window_ms) // 2]

    K, T = cfg.num_proposals, cfg.max_des_len - 1
    require(tuple(out["lang_cap"].shape) == (B, K, T), "lang_cap shape")
    require(tuple(out["bbox_corner"].shape) == (B, K, 8, 3), "bbox_corner shape")
    require(tuple(out["object_assignment"].shape) == (B, K),
            "object_assignment shape (detection loss)")
    for k, v in out.items():
        if v.is_floating_point():
            require(bool(torch.isfinite(v).all()), f"{k} not finite")

    # stage times of one forward (synchronised sections, CUDA events)
    stages = {}
    with torch.inference_mode():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        d = model.backbone_net(batch)
        ev[1].record()
        vx, vf = model.vgen(d["fp2_xyz"], d["fp2_features"])
        d = model.proposal(vx, l2_normalize_votes(vf), d)
        ev[2].record()
        d = model.graph(d)
        ev[3].record()
        d = model.caption(d, False, True)
        ev[4].record()
        torch.cuda.synchronize()
        for i, name in enumerate(("backbone", "voting+proposal", "graph",
                                  "caption")):
            stages[name] = ev[i].elapsed_time(ev[i + 1])

    # device busy share of one step: summed kernel time from a profiler
    # trace over the step's wall time; the trace must hold every FPS launch
    profile_report = profile_step(lambda: step(batch), "serving")
    device_ms = profile_report["kernel_ms"]
    profile_report["busy_share_profiled"] = (
        device_ms / profile_report["profiled_wall_ms"])

    # the same weights and batch on the CPU (plain versions) as reference
    with torch.inference_mode():
        gpu = model(batch)
        t0 = time.perf_counter()
        cpu_model = CapNet(cfg, num_vocabs=NUM_VOCABS, device="cpu", seed=0)
        ref = cpu_model(to_device(host, "cpu"))
        cpu_ms = (time.perf_counter() - t0) * 1e3
    report = {}
    for k in ("sa1_inds", "sa2_inds", "fp2_inds", "aggregated_vote_inds",
              "edge_nbr_idx", "bbox_mask"):
        a, b = gpu[k].cpu().long(), ref[k].long()
        diff = (a != b).nonzero()
        report[k] = "exact" if len(diff) == 0 else \
            f"differs at {diff[0].tolist()}: {a[tuple(diff[0])]} vs {b[tuple(diff[0])]}"
        require(len(diff) == 0, f"{k}: GPU != CPU reference ({report[k]})")
    corner_err = float((gpu["bbox_corner"].cpu() - ref["bbox_corner"]).abs().max())
    require(corner_err <= 1e-3, f"bbox_corner max abs err {corner_err}")
    tok_gpu, tok_ref = gpu["lang_cap"].cpu(), ref["lang_cap"]
    agree = float((tok_gpu == tok_ref).float().mean())
    if agree < 1.0:
        first = (tok_gpu != tok_ref).nonzero()[0].tolist()
        report["lang_cap_first_diff"] = first
    require(agree >= 0.99, f"lang_cap token agreement {agree}")
    profile_report["busy_share_of_steady_step"] = device_ms / ms
    return dict(batch=B, num_points=cfg.num_points, in_channels=pc.shape[-1],
                num_proposals=K, hidden_size=cfg.hidden_size,
                vocab=NUM_VOCABS, requests_per_window=requests,
                window_ms_per_batch=window_ms, ms_per_batch=ms,
                ms_spread=max(window_ms) - min(window_ms),
                scenes_per_s=B / ms * 1e3, first_call_ms=first_ms,
                stage_ms=stages, launches=launches, profile=profile_report,
                cpu_reference_ms=cpu_ms, bbox_corner_max_abs_err=corner_err,
                lang_cap_agreement=agree, parity=report,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)


# --------------------------------------------------------------------- phase 5
def condition_weights(torch, model):
    """Bring two layers of the seeded random model into a trained model's
    range (the same on every device): a fresh voting head throws its votes
    metres away, so that no proposal is a positive, and the sum-aggregated
    graph messages reach the hundreds, where float32 has 5 digits left."""
    with torch.no_grad():
        model.vgen.conv3.weight.mul_(0.02)
        for layer in (model.graph.gc_0, model.graph.gc_1,
                      model.graph.edge_layer):
            layer.map_edge_1.weight.mul_(0.1)


def grad_norms(model):
    return {n: float(p.grad.double().norm()) for n, p in model.named_parameters()}


def train_flagship(torch, np, warmup=3, steps=10, windows=3, lr=1e-3,
                   bn_momentum=0.1):
    from scan2cap_torch.config import flagship_config
    from scan2cap_torch.data.synthetic import to_device
    from scan2cap_torch.kernels import WRAPPERS, reset_launch_counts
    from scan2cap_torch.losses import get_scene_cap_loss
    from scan2cap_torch.models import CapNet
    from scan2cap_torch.models.voting import l2_normalize_votes
    from scan2cap_torch.train.step import (REPORT_KEYS, create_train_state,
                                           make_train_step)

    # the caption loss counts a sample only if its best proposal overlaps
    # the reference box by more than min_iou (0.25 in training proper); a
    # randomly initialised detector rarely gets there, so the smoke run
    # opens the gate to any overlap and the loss reaches the decoder
    cfg = flagship_config(min_iou=0.0)
    B = 2
    host = flagship_batch(np, cfg, B)
    batch = to_device(host, "cuda")

    def build(device):
        model = CapNet(cfg, num_vocabs=NUM_VOCABS, device=device, seed=0)
        condition_weights(torch, model)
        state = create_train_state(cfg, model)
        return model, state, make_train_step(cfg, state, **TRAIN_LOSSES)

    model, state, step = build("cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    first = step(batch, lr, bn_momentum)                  # step 1
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    first = {k: float(v) for k, v in first.items()}
    gpu_norms = grad_norms(model)
    require(set(first) == set(REPORT_KEYS), f"metrics {sorted(first)}")
    require(all(np.isfinite(v) for v in first.values()),
            f"step 1 metrics not finite: {first}")
    require(0 < first["pos_ratio"] < 1 and first["cap_loss"] > 0
            and first["ori_loss"] > 0 and first["box_loss"] > 0,
            f"degenerate training batch: {first}")

    # step 1 again on the CPU: the same weights and batch through the
    # port's plain versions, at the full size
    t0 = time.perf_counter()
    cpu_model, _, cpu_step = build("cpu")
    cpu_first = {k: float(v) for k, v in
                 cpu_step(to_device(host, "cpu"), lr, bn_momentum).items()}
    cpu_norms = grad_norms(cpu_model)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    del cpu_model, cpu_step
    loss_rel = abs(first["loss"] - cpu_first["loss"]) / abs(cpu_first["loss"])
    require(loss_rel <= 1e-3, f"step-1 loss: card {first['loss']} vs CPU "
            f"{cpu_first['loss']} (rel {loss_rel})")
    total = float(np.sqrt(sum(v * v for v in cpu_norms.values())))
    worst_name, worst_rel = None, 0.0
    for n, want in cpu_norms.items():
        # 1e-2 relative; a tensor whose norm is a rounding residue (a bias
        # ahead of a batch norm) is held to 1e-6 of the whole gradient
        rel = abs(gpu_norms[n] - want) / max(want, 1e-6 * total)
        if rel > worst_rel:
            worst_name, worst_rel = n, rel
    require(worst_rel <= 1e-2, f"gradient norm of {worst_name}: card "
            f"{gpu_norms[worst_name]} vs CPU {cpu_norms[worst_name]}")

    for _ in range(warmup - 1):
        step(batch, lr, bn_momentum)
    torch.cuda.synchronize()
    reset_launch_counts()
    window_ms, losses = [], []
    for _ in range(windows):
        t0 = time.perf_counter()
        span = [step(batch, lr, bn_momentum)["loss"] for _ in range(steps)]
        torch.cuda.synchronize()
        window_ms.append((time.perf_counter() - t0) * 1e3 / steps)
        losses += [float(v) for v in span]
    taken = steps * windows
    launches = {w.__name__: w.launches for w in WRAPPERS}
    per_step = {k: v / taken for k, v in launches.items()}
    require(per_step["furthest_point_sample_cuda"] == 5
            and per_step["ball_query_cuda"] == 5,
            f"FPS / ball query launches per step {per_step}, want 5")
    require(per_step["group_points_cuda"] == 6,
            f"gather launches per step {per_step}, want 5 forward + 1 in "
            f"the sa1 backward")
    require(all(np.isfinite(v) for v in losses), f"loss not finite: {losses}")
    require(losses[-1] < losses[0] and min(losses[-3:]) < first["loss"],
            f"loss did not fall on a repeated batch: {losses}")
    ms = sorted(window_ms)[len(window_ms) // 2]

    # stage times of one step (CUDA events between the stages)
    names = ("backbone", "voting+proposal", "graph", "caption", "loss",
             "backward", "optimizer")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
    model.train()
    state.optimizer.zero_grad(set_to_none=True)
    ev[0].record()
    d = model.backbone_net(batch, True, bn_momentum)
    d["seed_inds"], d["seed_xyz"] = d["fp2_inds"], d["fp2_xyz"]
    d["seed_features"] = d["fp2_features"]
    ev[1].record()
    vx, vf = model.vgen(d["fp2_xyz"], d["fp2_features"], True, bn_momentum)
    d["vote_xyz"], d["vote_features"] = vx, l2_normalize_votes(vf)
    d = model.proposal(vx, d["vote_features"], d, True, bn_momentum)
    ev[2].record()
    d = model.graph(d)
    ev[3].record()
    d = model.caption(d, True, False)
    ev[4].record()
    d = get_scene_cap_loss(d, num_bins=cfg.num_bins, **TRAIN_LOSSES)
    ev[5].record()
    d["loss"].backward()
    ev[6].record()
    state.optimizer.step()
    ev[7].record()
    torch.cuda.synchronize()
    stages = {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}

    # device busy share: summed kernel time of one profiled step; the
    # trace must hold every FPS launch
    profile_report = profile_step(lambda: step(batch, lr, bn_momentum),
                                  "training")
    profile_report["busy_share_of_steady_step"] = (
        profile_report["kernel_ms"] / ms)
    return dict(batch=B, num_points=cfg.num_points, num_proposals=cfg.num_proposals,
                hidden_size=cfg.hidden_size, vocab=NUM_VOCABS,
                losses_on=TRAIN_LOSSES, min_iou=cfg.min_iou, lr=lr,
                bn_momentum=bn_momentum,
                steps_per_window=steps, window_ms_per_step=window_ms,
                ms_per_step=ms, ms_spread=max(window_ms) - min(window_ms),
                scenes_per_s=B / ms * 1e3, first_step_ms=first_ms,
                launches_per_step=per_step, launches=launches,
                stage_ms=stages, step1=first, loss_by_step=losses,
                cpu_reference=dict(num_points=cfg.num_points, size="full",
                                   ms=cpu_ms, loss=cpu_first["loss"],
                                   loss_rel_err=loss_rel,
                                   worst_grad_norm_rel_err=worst_rel,
                                   worst_grad_norm_tensor=worst_name,
                                   tensors=len(cpu_norms)),
                profile=profile_report,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)


# --------------------------------------------------------------------- phase 6
def run_probes(torch):
    """The probes' own entry points on the card; returns their launches."""
    from scan2cap_torch.kernels import WRAPPERS, reset_launch_counts
    from scan2cap_torch.probes import gather, pack, shift

    reset_launch_counts()
    report = {}
    for name, mod in (("pack", pack), ("shift", shift)):
        lines, nbad = mod.run("cuda")
        print("\n".join(f"  {name}: {line}" for line in lines), flush=True)
        require(nbad == 0, f"probe {name}: {nbad} wrong")
        report[name] = dict(wrong=nbad, rows=len(pack.VALS))
    g = gather.run("cuda", iters=20)
    require(g["equal"], "gather probe: kernel rows != torch.gather rows")
    report["gather"] = g
    report["launches"] = {w.__name__: w.launches for w in WRAPPERS}
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel checks (phase 3)")
    ap.add_argument("--skip", nargs="+", default=[],
                    choices=["serve", "train", "probes"],
                    help="leave out a path while bringing up another "
                         "(exit 3 by design: not a whole run)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "scan2cap_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(scan2cap_torch/ not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from scan2cap_torch.kernels import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                            "--format=csv,noheader,nounits"],
                           capture_output=True, text=True, timeout=60,
                           check=True)
    sm_clock_mhz = float(clock.stdout.strip().splitlines()[0])
    print(f"largest SM clock: {sm_clock_mhz:.0f} MHz", flush=True)

    t0 = time.perf_counter()
    logs = _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.1f} s", flush=True)
    resources = {name: _build.kernel_resources(log)
                 for name, log in logs.items()}
    for name, kernels_built in resources.items():
        for k in kernels_built:
            print(f"  {name}: {k['name'][-44:]}: {k.get('registers')} registers, "
                  f"{k.get('spill_stores')} + {k.get('spill_loads')} bytes "
                  f"spilled, {k.get('smem')} bytes static shared", flush=True)
    # the FPS kernel's state lives in registers: a spill would put memory
    # traffic back into its loop
    spilled = [k["name"] for k in resources["fps"]
               if k.get("spill_stores") or k.get("spill_loads")]
    require(not spilled, f"FPS kernel variants spill registers: {spilled}")
    # the ball query's main-path variants must keep their queries in
    # registers; another variant that spills is reported
    from scan2cap_torch.kernels import ballquery
    on_path = {ballquery.bq_variant(N, M, s) for _, N, M, _, s in BQ_SITES}
    built = {ballquery.kernel_of_name(k["name"]): k
             for k in resources["ballquery"]}
    spilled = sorted(key for key, k in built.items()
                     if k.get("spill_stores") or k.get("spill_loads"))
    print("ball query (variant, pack) kernels that spill: "
          f"{spilled or 'none'}", flush=True)
    for v in on_path:
        for pack in (False, True):
            require((v, pack) in built, f"the build log holds no ball-query "
                    f"kernel of variant {ballquery.VARIANTS[v]}")
        require((v, False) not in spilled, f"the main-path ball query "
                f"variant {ballquery.VARIANTS[v]} spills registers")

    t0 = time.perf_counter()
    (fps_sites, bq_sites, pack_sites, gather_sites,
     probe_sites) = check_kernels(torch, np, sm_clock_mhz)
    print(f"kernel checks: {time.perf_counter() - t0:.1f} s", flush=True)

    # each path starts from launch counts of 0 and is read just after
    partial = args.kernels_only or args.skip
    paths = {}
    serve = train = probes = None
    if not args.kernels_only:
        if "serve" not in args.skip:
            t0 = time.perf_counter()
            serve = serve_flagship(torch, np)
            paths["serve"] = serve["launches"]
            print(f"serving phase: {time.perf_counter() - t0:.1f} s", flush=True)
        if "train" not in args.skip:
            t0 = time.perf_counter()
            train = train_flagship(torch, np)
            paths["train"] = train["launches"]
            print(f"training phase: {time.perf_counter() - t0:.1f} s", flush=True)
        if "probes" not in args.skip:
            t0 = time.perf_counter()
            probes = run_probes(torch)
            paths["probes"] = probes["launches"]
            print(f"probe phase: {time.perf_counter() - t0:.1f} s", flush=True)

    def launches(wrapper):
        return {path: run[wrapper] for path, run in paths.items()} or None

    bq = "scan2cap_torch/csrc/ballquery.cu"
    probe_cu = "scan2cap_torch/csrc/pack_probe.cu"
    kernels = [
        kernel_entry("fps", "scan2cap_torch/csrc/fps.cu",
                     "scan2cap_tpu/ops/pallas/fps.py:117", fps_sites,
                     launches("furthest_point_sample_cuda")),
        kernel_entry("ball_query", bq,
                     "scan2cap_tpu/ops/pallas/ballquery.py:58", bq_sites,
                     launches("ball_query_cuda")),
        # the pack entry point holds the Pallas (words, counts) contract;
        # the model uses the fused first-k entry point, the pack probe
        # drives this one
        kernel_entry("ball_query_pack", bq,
                     "scan2cap_tpu/ops/pallas/ballquery.py:58", pack_sites,
                     launches("ball_query_pack_cuda")),
        kernel_entry("gather", "scan2cap_torch/csrc/gather.cu",
                     "scripts/micro_vmem_gather.py:44", gather_sites,
                     launches("group_points_cuda")),
        kernel_entry("pack_probe", probe_cu,
                     "scripts/micro_mxu_pack_probe.py:31",
                     probe_sites["pack_probe"], launches("pack_probe_cuda")),
        kernel_entry("shift_probe", probe_cu,
                     "scripts/micro_mxu_shift_probe.py:30",
                     probe_sites["shift_probe"], launches("shift_probe_cuda")),
    ]
    if not partial:
        for k in kernels:
            require(k["launches"] > 0,
                    f"kernel {k['name']} was launched by no path")
    print(json.dumps({"kernels": kernels, "card": card,
                      "sm_clock_mhz": sm_clock_mhz, "build_s": build_s,
                      "build": resources}))
    if serve is not None:
        print(json.dumps({"serve": serve, "card": card}))
    if probes is not None:
        print(json.dumps({"probes": probes, "card": card}))
    if train is not None:
        print(json.dumps({"train": train, "card": card}))
    if partial:
        return 3
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
