#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``scan2cap_torch``) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit, no result printed):
  1. card name and power limit (nvidia-smi); no CUDA -> exit 1;
  2. build the CUDA kernels (one nvcc per source, in parallel);
  3. each kernel against its plain PyTorch version on the card, at the
     main-path shapes (B=2) plus edge cases: FPS (every boundary between
     its variants, scenes smaller than a cluster, ties and padding across
     the blocks of a cluster, ten clusters in flight, scenes of 81,921
     to 163,840 points in a cluster of 16 blocks (ties and padding across
     its blocks, ten scenes of 100,000), of 200,000 in the shared-state
     tier, the 16-block, shared-state and streaming variants forced onto
     small scenes), ball query, fused and pack (every
     boundary between its variants, N no multiple of a word, of 4 or of a
     chunk, hits that end and start a range, padding from a later range,
     points on the radius at range and chunk ends, the largest nsample
     held in shared memory, nsample 257, 512 and 1024 through the ordered
     scan with the nsample-th hit at a chunk's end and start, hits only in
     the last chunk and queries without hits, ten scenes of 40,000
     points, views off a 16-byte boundary), the row gather at its eight
     sites (odd and
     even widths, views off a 16-byte boundary, a ragged row count), and
     the two pack-tile probes (eight tiles, from all zeros to all ones;
     HGMMA in their library's SASS, no spill; an empty launch of their
     grid timed beside them); indices, words, counts
     and gathered rows
     must be equal; kernel, plain and library-call times and the bound at
     those shapes, and the kernels' own time on the device from a profiler
     trace beside the event time; the same for the tiers above the main
     path's shapes (FPS over 100,000, 150,000 and 200,000 points, and
     streaming 400,001; the ordered first-k at sa1's shape with nsample
     512 and 1024); and each of FPS, the first-k (the ordered scan) and
     the gather at MaskVoteNet's vote aggregation (B=16: one pick of
     1,024 votes, one query of radius 5 m and 512 samples a scene, (1, 512)
     rows of width 128);
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
  6. evaluate as scripts/eval.py --eval_caption --eval_detection does:
     the flagship (conditioned as in 5) over three synthetic batches
     through ``eval_helper.eval_cap`` and the AP loop at 0.25 and 0.5, then
     one batch each of the CLI's default caption heads at full width
     (``SceneCaptionModule``; top-down with ``num_locals=-1``) against the
     port on the CPU (tokens >= 99% equal, attention within 1e-3): launch
     counts per forward, ms per batch of the host loop, post-processing
     and NMS ms (and NMS's device operations per call); the same forward
     outputs post-processed on the CPU (every gate's mask, detected ids,
     candidates exact, AP within 1e-6); an oracle detector (each GT box and
     three shrunk copies) whose duplicates NMS must remove, whose mAP must
     read 1 and whose captions become one candidate per GT object, the same
     on the card and the CPU; scoring seconds over those candidates;
  7. the probes' entry points (``scan2cap_torch.probes``): every row right;
     the flagship's eval forward at 150,000 points (B=2, 10 requests: sa1's
     FPS in a 16-block cluster, its indices exact against the plain
     version, ms per batch); the ops' entry points on a 200,000-point scene
     (FPS in the shared-state tier, the ordered first-k at nsample 512)
     and on 400,001 points (FPS streamed);
  8. the port's command-line entry points as subprocesses on ScanNet-layout
     fixture data written here (6 train and 2 val scenes of 150,000
     points, 12 boxes each, a 3,433-word vocabulary): train one epoch of
     15 steps at B=8 with the flagship's flags less multiview (the
     in-training eval fires), resume to epoch 2, eval captions and
     detection, predict, then the offline flow of launch/benchmark.sh
     (build the GT boxes, score pred.json into eval_results.json); every
     loss finite, the resume at global epoch 2
     with the optimizer's count, last.pt and its reference-layout export
     reloaded bit-equal, pred.json for both val scenes, the native data
     plane built, launches per train step and per eval forward the
     structure's; ms per step, fetch s, __getitem__ ms (native, numpy),
     eval, predict and checkpoint-save ms (the runs' own stats files);
  9. MaskVoteNet (``launch/train_maskvotenet.sh``: B=16, multiview +
     normal + height + mask over 40,000 points) through
     ``make_mask_votenet_step`` on a repeated synthetic batch: every FPS,
     first-k and gather launch of step 2 (forward and backward, B=16)
     held exactly against its plain version on the same inputs on the
     card; step 1 of a fresh model at B=4 against the port on the CPU
     (loss 1e-3, gradient norms 1e-2), the
     loss falls, miou finite, launches per step (5 FPS, 5 first-k of which
     1 through the ordered scan, 6 gathers), ms per step over three
     spans, kernel ms and busy share from a profiled step; then
     ``scan2cap_torch.scripts.train_maskvotenet`` as a subprocess on the
     fixture of 8 at B=16 with --use_normal for two epochs: the same
     launches per step, last.pt and its reference-layout export reloaded
     bit-equal, ms per iteration, fetch s, save ms, __getitem__ ms;
 10. the offline scorer on tests/fixtures/benchmark_mini with NMS and the
     rotated assignment on the card: equal to the CPU's results within
     1e-6 and to the pinned values, seconds per stage;
 11. the JSON lines: kernels, serving, training, eval, cli, mvn,
     benchmark, and last the device line.
Launch counts are set to 0 just before each of the paths 4-7 and 9 and
read just after; the entry points of 8 and 9 count their own (their stats
files).
``--kernels-only`` stops after phase 3 (a short first check of a new
kernel).  Imports nothing of JAX.
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
# (name, ball-query site of its indices, N, C, M, S) of the row gather: the
# five grouping sites of a flagship forward (the gather-lean layers gather
# their layer-0 projection), the sa1 backward's gather of the raw 3 + 135
# channels, and the two gathers of a height-only sa1 (the CLI-default
# caption heads: 1 input channel, not gather-lean), xyz and height apart
GATHER_SITES = (("sa1", "sa1", 40000, 64, 2048, 64),
                ("sa1_backward", "sa1", 40000, 138, 2048, 64),
                ("sa1_xyz", "sa1", 40000, 3, 2048, 64),
                ("sa1_height", "sa1", 40000, 1, 2048, 64),
                ("sa2", "sa2", 2048, 128, 1024, 32),
                ("sa3", "sa3", 1024, 128, 512, 16),
                ("sa4", "sa4", 512, 128, 256, 16),
                ("vote_aggregation", "vote_aggregation", 1024, 128, 256, 16))
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


def fps_bound_ms(B, N, npoint):
    """FPS's bound: every point read once, the picks written, the distance
    updates of npoint - 1 steps.  One pick is index 0: only it is written."""
    if npoint == 1:
        return bound_ms(B * 4, 0)
    return bound_ms(B * N * 12 + B * npoint * 4,
                    B * (npoint - 1) * N * FPS_OPS_PER_POINT)


def first_k_bound_ms(torch, want, total, N, nsample):
    """The first-k's bound from this data: a query stops at its nsample-th
    hit (the last index of a full list) or tests all N points; a scene's
    points are read up to the furthest any of its queries tests, its
    queries read and its lists written once.  ``want`` (B, M, nsample) the
    indices, ``total`` (B, M) the hits.  Returns (ms, by, pairs tested)."""
    B, M, _ = want.shape
    tested = torch.where(total >= nsample, want[..., -1].long() + 1,
                         torch.full_like(total, N).long())
    pairs, points = int(tested.sum()), int(tested.amax(-1).sum())
    ms, by = bound_ms(points * 12 + B * M * 12 + B * M * nsample * 4,
                      pairs * BQ_OPS_PER_PAIR)
    return ms, by, pairs


def gather_bound_ms(torch, idx, C):
    """The row gather's bound: each distinct row that idx names read once,
    idx read, the (B, M, S, C) rows written."""
    B = idx.shape[0]
    rows = sum(int(torch.unique(i).numel()) for i in idx.reshape(B, -1))
    return bound_ms(rows * C * 4 + idx.numel() * 4 + idx.numel() * C * 4, 0)


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
    """The device's own time (``ms``) and operations (kernels and copies,
    ``ops_per_call``) per call of fn(), from a profiler trace."""
    from scan2cap_torch.probes.timing import device_ms
    r = device_ms(fn, iters)
    require(r["complete"], f"the profiler's trace holds {r['launches']} "
            f"operations per call after {r['attempts']} passes")
    return dict(ms=r["ms"], ops_per_call=r["launches"])


# --------------------------------------------------------------------- phase 3
def check_fps_edges(torch):
    """Every FPS edge case: the kernel's indices equal the plain version's,
    or the run fails; scenes above what 8 blocks' registers hold go through
    the 16-block, shared-state or streaming tier."""
    from scan2cap_torch.kernels import furthest_point_sample_cuda
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
    return len(FPS_EDGE_CASES)


def check_bq_edges(torch):
    """Every ball-query edge case through both entry points: indices, words
    and counts equal the plain versions', or the run fails (an nsample
    above 256 takes the ordered scan)."""
    from scan2cap_torch.kernels import ball_query_cuda, ball_query_pack_cuda
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
    return len(BQ_EDGE_CASES)


def check_kernels(torch, np, sm_clock_mhz):
    from scan2cap_torch.kernels import ball_query_cuda, ball_query_pack_cuda
    from scan2cap_torch.kernels import ballquery
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
        fps_sites.append(fps_site(torch, x, npoint, name,
                                  5 if N > 10000 else 20))

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
        b_ms, by, pairs = first_k_bound_ms(torch, want, cp.sum(-1), N, s)
        io = B * N * 12 + B * M * 12
        variant = list(ballquery.VARIANTS[ballquery.bq_variant(N, M, s)])

        ms = cuda_ms(torch, lambda: ball_query_cuda(pts, q, r2, s), iters=20)
        dms = device_only_ms(lambda: ball_query_cuda(pts, q, r2, s), 20)["ms"]
        pms = cuda_ms(torch, lambda: ball_query_plain(pts, q, r, s), iters=2)
        bq_sites.append(dict(site=name, shape=[B, N, M, s], radius=r, ms=ms,
                             device_ms=dms, variant=variant,
                             plain_ms=pms, bound_ms=b_ms, bound_by=by,
                             pairs_tested=pairs,
                             issue_floor_ms=issue_floor_ms(pairs, sm_clock_mhz),
                             max_abs_err=int((got - want).abs().max())))
        W = wk.shape[-1]
        ms = cuda_ms(torch, lambda: ball_query_pack_cuda(pts, q, r2), iters=20)
        dms = device_only_ms(lambda: ball_query_pack_cuda(pts, q, r2),
                             20)["ms"]
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
    variant_sites = check_large_variants(torch, np, xyz0, bq_in["sa1"][1],
                                         sm_clock_mhz)
    gather_sites = check_gather(torch, bq_idx)
    # MaskVoteNet's vote aggregation: one more site of each kernel
    mvn = check_mvn_sites(torch, sm_clock_mhz)
    fps_sites.append(mvn["fps"])
    variant_sites["ball_query_ordered"].insert(0, mvn["ball_query_ordered"])
    gather_sites.append(mvn["gather"])
    probe_sites = check_probes(torch)
    return (fps_sites, bq_sites, pack_sites, gather_sites, probe_sites,
            variant_sites)


# (name, N, npoint, tier) of FPS above what 8 blocks' registers hold, and
# (name, N, M, radius, nsample) of the ordered first-k at sa1's shape
FPS_LARGE_SITES = (("room_100000", 100000, 2048, "cluster16"),
                   ("room_150000", 150000, 2048, "cluster16"),
                   ("room_200000", 200000, 2048, "shared_state"),
                   ("room_400001", 400001, 256, "streamed"))
BQ_ORDERED_SITES = (("sa1_nsample512", 40000, 2048, 0.4, 512),
                    ("sa1_nsample1024", 40000, 2048, 0.4, 1024))


def fps_site(torch, x, npoint, name, iters):
    """One FPS site: exact against the plain version, ms by events and
    on the device, the plain version's ms, the bound from this run."""
    from scan2cap_torch.kernels import fps, furthest_point_sample_cuda
    from scan2cap_torch.ops.sampling import furthest_point_sample_plain

    B, N, _ = x.shape
    got = furthest_point_sample_cuda(x, npoint)
    want = furthest_point_sample_plain(x, npoint)
    torch.cuda.synchronize()
    require(torch.equal(got, want), f"fps site {name}: kernel != plain")
    ms = cuda_ms(torch, lambda: furthest_point_sample_cuda(x, npoint),
                 iters=iters)
    dms = device_only_ms(lambda: furthest_point_sample_cuda(x, npoint),
                         iters)["ms"]
    pms = cuda_ms(torch, lambda: furthest_point_sample_plain(x, npoint),
                  iters=1)
    b_ms, by = fps_bound_ms(B, N, npoint)
    return dict(site=name, shape=[B, N, npoint], ms=ms, device_ms=dms,
                us_per_step=dms * 1e3 / (npoint - 1) if npoint > 1 else None,
                variant=list(fps.VARIANTS[fps.fps_variant(N)]),
                plain_ms=pms, bound_ms=b_ms, bound_by=by,
                max_abs_err=int((got - want).abs().max()))


def first_k_site(torch, pts, q, r, s, name, sm_clock_mhz, iters=20):
    """One first-k site: exact against the plain version, ms by events and
    on the device, the plain version's ms, the bound from this run's hits,
    and the bytes the call allocates (its output alone)."""
    from scan2cap_torch.kernels import ball_query_cuda, ballquery
    from scan2cap_torch.ops.grouping import (ball_query_pack_plain,
                                             ball_query_plain, radius_squared)

    B, N, _ = pts.shape
    M = q.shape[1]
    r2 = radius_squared(r)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    got = ball_query_cuda(pts, q, r2, s)
    allocated = torch.cuda.memory_allocated() - before
    want = ball_query_plain(pts, q, r, s)
    total = ball_query_pack_plain(pts, q, r2)[1].sum(-1)
    torch.cuda.synchronize()
    require(torch.equal(got, want), f"ball_query site {name}: kernel != plain")
    # the caching allocator hands out blocks of 512 bytes: idx and no more
    require(allocated == -(-got.numel() * 4 // 512) * 512,
            f"ball_query site {name}: the call allocated {allocated} bytes "
            f"for an output of {got.numel() * 4}")
    b_ms, by, pairs = first_k_bound_ms(torch, want, total, N, s)
    v = ballquery.bq_variant(N, M, s)
    return dict(site=name, shape=[B, N, M, s], radius=r,
                ms=cuda_ms(torch, lambda: ball_query_cuda(pts, q, r2, s),
                           iters=iters),
                device_ms=device_only_ms(
                    lambda: ball_query_cuda(pts, q, r2, s), iters)["ms"],
                variant=list(ballquery.VARIANTS[v]),
                plain_ms=cuda_ms(torch, lambda: ball_query_plain(
                    pts, q, r, s), iters=2),
                bound_ms=b_ms, bound_by=by, pairs_tested=pairs,
                queries_filled=float((total >= s).float().mean()),
                issue_floor_ms=issue_floor_ms(pairs, sm_clock_mhz),
                allocated_bytes=allocated,
                max_abs_err=int((got - want).abs().max()))


def check_large_variants(torch, np, xyz0, q0, sm_clock_mhz):
    """The tiers that lift the limits of the main path's shapes: FPS over
    rooms of 100,000 and 150,000 points (a 16-block cluster's registers),
    200,000 (the shared-state tier) and 400,001 (streamed), and the ordered
    first-k at sa1's shape with nsample 512 and 1024.  Exact against the
    plain versions; times as for the main-path sites."""
    from scan2cap_torch.kernels import ballquery, fps
    from scan2cap_torch.probes.bq_variants import room

    dev = torch.device("cuda")
    B = xyz0.shape[0]
    sites = dict(fps_cluster16=[], fps_shared_state=[], fps_streamed=[],
                 ball_query_ordered=[])
    for i, (name, N, npoint, where) in enumerate(FPS_LARGE_SITES):
        require(fps.tier(fps.fps_variant(N)) == where,
                f"N={N} does not get the {where} FPS tier")
        x = torch.from_numpy(room(np.random.RandomState(3 + i), B, N)).to(dev)
        sites[f"fps_{where}"].append(fps_site(torch, x, npoint, name, 3))

    for name, N, M, r, s in BQ_ORDERED_SITES:
        require(xyz0.shape[1] == N and q0.shape[1] == M, "sa1 inputs")
        require(ballquery.is_ordered(ballquery.bq_variant(N, M, s)),
                f"nsample {s} does not take the ordered scan")
        sites["ball_query_ordered"].append(
            first_k_site(torch, xyz0, q0, r, s, name, sm_clock_mhz))
    return sites


def check_mvn_sites(torch, sm_clock_mhz):
    """The three kernels at MaskVoteNet's vote aggregation
    (``probes/cases.py`` ``mvn_aggregation``): FPS picking 1 of 1,024 votes,
    the first-k at radius 5 m and nsample 512 (the ordered scan, one query
    a scene, a block of its own), the gather of (1, 512) rows of width 128;
    B=16.  Exact against the plain versions; times as for the main-path
    sites."""
    from scan2cap_torch.kernels import (ball_query_cuda,
                                        furthest_point_sample_cuda,
                                        group_points_cuda)
    from scan2cap_torch.kernels import ballquery
    from scan2cap_torch.ops.grouping import (ball_query_plain,
                                             group_points_plain,
                                             radius_squared)
    from scan2cap_torch.probes import cases

    dev = torch.device("cuda")
    name = "mvn_aggregation"
    x, npoint, _ = cases.fps_edge_case(name)
    x = torch.from_numpy(x).to(dev)
    B, N, _ = x.shape
    fps_row = fps_site(torch, x, npoint, name, 20)
    require(bool((furthest_point_sample_cuda(x, npoint) == 0).all()),
            "fps site mvn_aggregation: one pick must be index 0")

    pts, q, r, s, _, _ = cases.bq_edge_case(name)
    pts, q = torch.from_numpy(pts).to(dev), torch.from_numpy(q).to(dev)
    require(ballquery.is_ordered(ballquery.bq_variant(N, q.shape[1], s)),
            "the aggregation's first-k does not take the ordered scan")
    before = ball_query_cuda.ordered_launches
    ball_query_cuda(pts, q, radius_squared(r), s)
    require(ball_query_cuda.ordered_launches == before + 1,
            "the aggregation's first-k did not launch the ordered scan")
    bq_site = first_k_site(torch, pts, q, r, s, name, sm_clock_mhz)
    require(0 < bq_site["queries_filled"] < 1,
            "the aggregation case must hold short and full lists")
    want = ball_query_plain(pts, q, r, s)

    shape = cases.GATHER_EDGE_CASES[name]
    _, N, C, M, S, _ = shape
    g = torch.Generator().manual_seed(9)
    feats = torch.randn((B, N, C), generator=g).to(dev)
    idx = want                              # the first-k's own indices
    require(tuple(idx.shape) == (B, M, S), f"gather site {name}: {idx.shape}")
    got, want = group_points_cuda(feats, idx), group_points_plain(feats, idx)
    torch.cuda.synchronize()
    require(torch.equal(got, want), "gather site mvn_aggregation: "
            "kernel != plain")
    expand = idx.reshape(B, M * S).long()[..., None].expand(-1, -1, C)
    b_ms, by = gather_bound_ms(torch, idx, C)
    gather_site = dict(
        site=name, shape=[B, N, C, M, S],
        ms=cuda_ms(torch, lambda: group_points_cuda(feats, idx), iters=20),
        device_ms=device_only_ms(lambda: group_points_cuda(feats, idx),
                                 20)["ms"],
        library_device_ms=device_only_ms(
            lambda: torch.gather(feats, 1, expand), 20)["ms"],
        plain_ms=cuda_ms(torch, lambda: group_points_plain(feats, idx),
                         iters=20),
        library_ms=cuda_ms(torch, lambda: torch.gather(feats, 1, expand),
                           iters=20),
        bound_ms=b_ms, bound_by=by,
        max_abs_err=float((got - want).abs().max()))
    return dict(fps=fps_row, ball_query_ordered=bq_site,
                gather=gather_site)


def check_gather(torch, bq_idx):
    """The row gather against its plain version: edge cases, then the
    eight sites with the ball query's own indices.  Exact or fail."""
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
    for name, bq_site, N, C, M, S in GATHER_SITES:
        idx = bq_idx[bq_site]
        require(tuple(idx.shape) == (B, M, S), f"gather site {name}: {idx.shape}")
        feats = torch.randn((B, N, C), generator=g).to(dev)
        got, want = group_points_cuda(feats, idx), group_points_plain(feats, idx)
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"gather site {name}: kernel != plain")
        expand = idx.reshape(B, M * S).long()[..., None].expand(-1, -1, C)
        ms = cuda_ms(torch, lambda: group_points_cuda(feats, idx), iters=20)
        pms = cuda_ms(torch, lambda: group_points_plain(feats, idx), iters=20)
        lms = cuda_ms(torch, lambda: torch.gather(feats, 1, expand), iters=20)
        dms = device_only_ms(lambda: group_points_cuda(feats, idx), 20)["ms"]
        dlms = device_only_ms(lambda: torch.gather(feats, 1, expand),
                              20)["ms"]
        b_ms, by = gather_bound_ms(torch, idx, C)
        sites.append(dict(site=name, shape=[B, N, C, M, S], ms=ms,
                          device_ms=dms, library_device_ms=dlms,
                          plain_ms=pms, library_ms=lms, bound_ms=b_ms,
                          bound_by=by,
                          max_abs_err=float((got - want).abs().max())))
    return sites


def check_probes(torch):
    """The two pack-tile probe kernels against their plain versions on
    every tile of ``probes.pack.probe_tiles`` (crafted; densities 0.3, 0.05
    and 0.5; all ones; all zeros; a random 32-bit pattern in every word;
    rows of lo = hi = 65535): every float and every word equal.  The
    product must be on the tensor cores (HGMMA in the library's SASS).
    Times beside the device time of an empty launch of the same grid."""
    from scan2cap_torch.kernels import _build
    from scan2cap_torch.kernels import pack_probe as probe_kernels
    from scan2cap_torch.probes import pack, shift

    sass = _build.sass("pack_probe")
    hgmma = sum("HGMMA" in line for line in sass.splitlines())
    require(hgmma > 0, "csrc/pack_probe.cu: no HGMMA in the library's SASS, "
            "the product is not on the tensor cores")
    dev = torch.device("cuda")
    # views off the kernels' boundaries raise before a launch
    for call in (lambda x: probe_kernels.pack_probe_cuda(x),
                 lambda x: probe_kernels.shift_probe_cuda(
                     x, torch.zeros((1, 256, 128), dtype=torch.int32,
                                    device=dev))):
        off = torch.zeros(256 * 512 + 1, device=dev)[1:].view(1, 256, 512)
        try:
            call(off)
        except ValueError:
            continue
        raise PhaseError("a pack probe took a hit tile off a 16-byte "
                         "boundary")
    err = {"pack_probe": 0.0, "shift_probe": 0.0}
    tiles = pack.probe_tiles()
    for name, hit, ints in tiles:
        h, i = torch.from_numpy(hit).to(dev), torch.from_numpy(ints).to(dev)
        praw, pword = pack.pack_probe_plain(h)
        pouts = shift.shift_probe_plain(h, i)
        raw, word = probe_kernels.pack_probe_cuda(h)
        outs = probe_kernels.shift_probe_cuda(h, i)
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

    h = torch.from_numpy(tiles[1][1]).to(dev)          # density 0.3
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

    empty_ms = device_only_ms(lambda: probe_kernels.empty_launch_cuda(dev),
                              50)["ms"]
    flops = 2 * 256 * 48 * 512
    tile, out = 256 * 512 * 4, 256 * 128 * 4
    sites = {}
    for name, kern, plain, lib, nbytes in (
            ("pack_probe", lambda: probe_kernels.pack_probe_cuda(h),
             lambda: pack.pack_probe_plain(h), lib_pack, tile + 2 * out),
            ("shift_probe", lambda: probe_kernels.shift_probe_cuda(h, i),
             lambda: shift.shift_probe_plain(h, i), lib_shift,
             tile + out + 6 * out)):
        b_ms, by = bound_ms(nbytes, flops)
        sites[name] = [dict(site="tile", shape=[1, 256, 512],
                            split=probe_kernels.SPLIT,
                            ms=cuda_ms(torch, kern, iters=50),
                            device_ms=device_only_ms(kern, 50)["ms"],
                            empty_launch_device_ms=empty_ms,
                            plain_ms=cuda_ms(torch, plain, iters=50),
                            library_ms=cuda_ms(torch, lib, iters=50),
                            bound_ms=b_ms, bound_by=by,
                            max_abs_err=err[name], tiles=len(tiles),
                            hgmma_in_sass=hgmma)]
        print(f"  {name}: {sites[name][0]['device_ms']:.5f} ms on the "
              f"device (empty launch {empty_ms:.5f}), split "
              f"{probe_kernels.SPLIT}, {len(tiles)} tiles exact, "
              f"{hgmma} HGMMA",
              flush=True)
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
def flagship_batch(np, cfg, B, vocab=None, seed=0):
    """A synthetic flagship batch (host arrays): seeded normals and
    multiview features in place of the zeros."""
    from scan2cap_torch.data.synthetic import make_scene_batch, make_vocab
    if vocab is None:
        vocab = make_vocab(num_vocabs=NUM_VOCABS, emb_size=cfg.emb_size)
    host = make_scene_batch(cfg, batch_size=B, num_objects=8, vocab=vocab,
                            seed=seed)
    rs = np.random.RandomState(1 + seed)
    pc = host["point_clouds"]
    pc[..., 3:3 + 131] = rs.randn(B, cfg.num_points, 131).astype(np.float32) * 0.1
    require(pc.shape == (B, cfg.num_points, 135), f"flagship input {pc.shape}")
    return host


def serve_flagship(torch, np, requests=30, windows=3):
    from scan2cap_torch.config import flagship_config
    from scan2cap_torch.data.synthetic import to_device
    from scan2cap_torch.kernels import (ball_query_cuda, launch_counts,
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
    launches = launch_counts()
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


def step1_parity(np, first, cpu_first, card_norms, cpu_norms, what):
    """Step 1 on the card against the port's CPU run: the loss within 1e-3
    relative and every gradient norm within 1e-2 (a tensor whose norm is a
    rounding residue, a bias ahead of a batch norm, is held to 1e-6 of the
    whole gradient).  Returns (loss error, worst tensor, its error)."""
    loss_rel = abs(first["loss"] - cpu_first["loss"]) / abs(cpu_first["loss"])
    require(loss_rel <= 1e-3, f"{what} step-1 loss: card {first['loss']} "
            f"vs CPU {cpu_first['loss']} (rel {loss_rel})")
    total = float(np.sqrt(sum(v * v for v in cpu_norms.values())))
    worst_name, worst_rel = None, 0.0
    for n, want in cpu_norms.items():
        rel = abs(card_norms[n] - want) / max(want, 1e-6 * total)
        if rel > worst_rel:
            worst_name, worst_rel = n, rel
    require(worst_rel <= 1e-2, f"{what} gradient norm of {worst_name}: card "
            f"{card_norms[worst_name]} vs CPU {cpu_norms[worst_name]}")
    return loss_rel, worst_name, worst_rel


def train_flagship(torch, np, warmup=3, steps=10, windows=3, lr=1e-3,
                   bn_momentum=0.1):
    from scan2cap_torch.config import flagship_config
    from scan2cap_torch.data.synthetic import to_device
    from scan2cap_torch.kernels import launch_counts, reset_launch_counts
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
    loss_rel, worst_name, worst_rel = step1_parity(
        np, first, cpu_first, gpu_norms, cpu_norms, "CapNet")

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
    launches = launch_counts()
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
class EvalDataset:
    """What the eval loop reads of the reference dataset: the vocabulary,
    its embedding table and a ScanRefer entry per dataset index."""

    def __init__(self, vocab, scanrefer):
        self.vocabulary = vocab
        self.emb_table = vocab["emb_table"]
        self.scanrefer = scanrefer


def eval_data(np, cfg, vocab, n, B):
    """n synthetic flagship batches with their dataset indices, a dataset
    stub (one entry per scene), the organized dict (every object of a scene
    by id, named by its class) and the GT corpus (one seeded description
    per object)."""
    from scan2cap_torch.config import SCANNET_CLASS2TYPE
    from scan2cap_torch.eval.eval_helper import prepare_corpus

    rs = np.random.RandomState(11)
    words = [w for w in vocab["word2idx"] if w.startswith("word")][:40]
    batches, scanrefer, entries, organized = [], [], [], {}
    for s in range(n):
        host = flagship_batch(np, cfg, B, vocab=vocab, seed=s)
        host["dataset_idx"] = np.arange(s * B, (s + 1) * B, dtype=np.int32)
        batches.append(host)
        for b in range(B):
            scene = f"scene{s * B + b:04d}_00"
            scanrefer.append({"scene_id": scene})
            for o in np.nonzero(host["box_label_mask"][b])[0]:
                name = SCANNET_CLASS2TYPE[int(host["sem_cls_label"][b, o])]
                organized.setdefault(scene, {})[str(o)] = {
                    "0": {"object_name": name}}
                entries.append({"scene_id": scene, "object_id": str(o),
                                "object_name": name,
                                "token": list(rs.choice(words, 8))})
    return batches, EvalDataset(vocab, scanrefer), organized, \
        prepare_corpus(entries)


def replay_step(outs, dev):
    """An eval step that answers the i-th call with the i-th recorded
    output, moved to ``dev``: the card's forward outputs, post-processed
    on the card or on the CPU."""
    it = iter(outs)
    return lambda batch: {k: v.to(dev) for k, v in next(it).items()}


def ap_loop(torch, step, batches, emb_table, dev):
    """The AP loop of scripts/eval.py:188-205: per batch the eval step,
    ``parse_predictions_device`` and the host lists; returns the metrics
    at 0.25 and 0.5, the parsed masks and the seconds that computing the
    metrics took."""
    from scan2cap_torch.data.synthetic import to_device
    from scan2cap_torch.eval.ap_helper import (APCalculator,
                                               assemble_pred_map_cls,
                                               parse_groundtruths,
                                               parse_predictions_device)
    calcs = {t: APCalculator(t) for t in (0.25, 0.5)}
    emb = torch.as_tensor(emb_table).to(dev)
    masks = []
    for batch in batches:
        tb = to_device({k: v for k, v in batch.items()
                        if k != "glove_emb_table"}, dev)
        tb["glove_emb_table"] = emb
        out = step(tb)
        parsed = {k: v.cpu().numpy() for k, v in parse_predictions_device(
            {**out, "point_clouds": tb["point_clouds"]}).items()}
        preds = assemble_pred_map_cls(out["bbox_corner"].cpu().numpy(), parsed)
        gts = parse_groundtruths(batch)
        for c in calcs.values():
            c.step(preds, gts)
        masks.append(parsed)
    t0 = time.perf_counter()
    metrics = {t: c.compute_metrics() for t, c in calcs.items()}
    return metrics, masks, time.perf_counter() - t0


def oracle_outputs(torch, np, batch, out, dup=3):
    """A perfect detector's output for one batch: each GT box fills
    ``1 + dup`` slots (itself with the highest objectness, then copies
    shrunk by 1 to 3 percent), with its class and its assignment; every
    other slot is an empty box far from the scene.  ``lang_cap`` is the
    model's own."""
    corners = np.asarray(batch["gt_box_corner_label"], np.float32)
    valid = np.asarray(batch["box_label_mask"]) > 0
    B, K = out["objectness_scores"].shape[:2]
    C = out["sem_cls_scores"].shape[-1]
    far = 100.0 + np.float32([[x, y, z] for x in (0, 1) for y in (0, 1)
                              for z in (0, 1)])
    box = np.tile(far, (B, K, 1, 1))
    obj = np.tile(np.float32([5.0, -5.0]), (B, K, 1))
    sem = np.zeros((B, K, C), np.float32)
    assign = np.zeros((B, K), np.int64)
    slots = np.zeros((B, K), bool)
    for b in range(B):
        k = 0
        for m in np.nonzero(valid[b])[0]:
            center = corners[b, m].mean(0)
            for d in range(1 + dup):
                box[b, k] = center + (corners[b, m] - center) * (1 - 0.01 * d)
                obj[b, k] = [-5.0, 6.0 - d]
                sem[b, k, int(batch["sem_cls_label"][b, m])] = 10.0
                assign[b, k] = m
                slots[b, k] = d == 0
                k += 1
        require(k <= K, f"oracle: {k} slots for {K} proposals")
    oracle = dict(out)
    oracle.update(bbox_corner=torch.from_numpy(box),
                  objectness_scores=torch.from_numpy(obj),
                  sem_cls_scores=torch.from_numpy(sem),
                  object_assignment=torch.from_numpy(assign))
    return oracle, slots


def stage_counts(post):
    """Proposals left after each gate of ``postprocess_scene_cap``'s
    result: nonempty, after NMS, after objectness, past the IoU gate."""
    return {name: post[k].sum(-1).tolist() for name, k in (
        ("nonempty", "nonempty"), ("after_nms", "nms_mask"),
        ("after_objectness", "final_mask"), ("past_iou_gate", "keep"))}


def host_ms(torch, fn, iters, dev):
    """Mean wall time of fn() over iters calls, each ended by a sync."""
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def serve_decoder(torch, np, kind, dev, sizes, num_vocabs, requests):
    """One CLI-default caption head at full width (height only, no graph,
    ``num_locals=-1``): first call, ``requests`` timed calls, and the same
    weights and batch through the port on the CPU: tokens >= 99% equal,
    and the attention of every target whose tokens agree within 1e-3."""
    from scan2cap_torch.config import ModelConfig
    from scan2cap_torch.data.synthetic import (make_scene_batch, make_vocab,
                                               to_device)
    from scan2cap_torch.models import CapNet
    from scan2cap_torch.train.step import make_eval_step

    cfg = ModelConfig(num_locals=-1, use_topdown=kind == "topdown_full_k",
                      **sizes)
    vocab = make_vocab(num_vocabs=num_vocabs, emb_size=cfg.emb_size)
    host = make_scene_batch(cfg, batch_size=2, num_objects=8, vocab=vocab,
                            seed=3)
    model = CapNet(cfg, num_vocabs=num_vocabs, device=dev, seed=0)
    step = make_eval_step(cfg, model, keep_attn=True)
    batch = to_device(host, dev)
    first_ms = host_ms(torch, lambda: step(batch), 1, dev)
    ms = host_ms(torch, lambda: step(batch), requests, dev)
    out = step(batch)
    profile = None
    if dev.type == "cuda":
        # the card's busy share: summed kernel time of one request's trace
        from scan2cap_torch.probes.timing import profile_calls
        rows = profile_calls(lambda: step(batch))["rows"]
        profile = dict(kernel_ms=sum(t for t, _, _ in rows),
                       kernels=sum(c for _, _, c in rows))
        profile["busy_share"] = profile["kernel_ms"] / ms
    ref = make_eval_step(cfg, CapNet(cfg, num_vocabs=num_vocabs, device="cpu",
                                     seed=0), keep_attn=True)(
        to_device(host, "cpu"))
    K, T = cfg.num_proposals, cfg.max_des_len - 1
    tok, tok_ref = out["lang_cap"].cpu(), ref["lang_cap"]
    require(tuple(tok.shape) == (2, K, T), f"{kind}: lang_cap {tok.shape}")
    for k, v in out.items():
        if v.is_floating_point():
            require(bool(torch.isfinite(v).all()), f"{kind}: {k} not finite")
    agree = float((tok == tok_ref).float().mean())
    require(agree >= 0.99, f"{kind}: token agreement {agree}")
    # sa1 of a height-only model is not gather-lean (4 input channels,
    # fewer than its first layer's 64): it gathers xyz and features apart
    gathers = 5 + (not model.backbone_net.sa1.gather_lean)
    report = dict(config=dict(num_points=cfg.num_points, num_proposals=K,
                              hidden_size=cfg.hidden_size,
                              use_topdown=cfg.use_topdown,
                              num_locals=cfg.num_locals,
                              in_channels=host["point_clouds"].shape[-1]),
                  first_call_ms=first_ms, ms_per_batch=ms, requests=requests,
                  lang_cap_agreement=agree, profile=profile,
                  forwards=requests + 2 + (dev.type == "cuda"),
                  gathers_per_forward=gathers)
    if cfg.use_topdown:
        attn, attn_ref = out["topdown_attn"].cpu(), ref["topdown_attn"]
        require(tuple(attn.shape) == (2, K, T, K), f"attn {attn.shape}")
        same = (tok == tok_ref).all(-1)                       # (B, K)
        err = float((attn - attn_ref).abs()[same].max())
        require(err <= 1e-3, f"{kind}: topdown_attn max abs err {err}")
        report.update(attn_max_abs_err=err, targets_compared=int(same.sum()),
                      attn_max_abs_err_all=float((attn - attn_ref).abs().max()))
    return report


def eval_flagship(torch, np, dev="cuda", sizes=None, num_vocabs=NUM_VOCABS,
                  nb=3, requests=5):
    """The evaluation of scripts/eval.py --eval_caption --eval_detection
    through the port: the flagship's ``eval_cap`` and AP loop on ``dev``,
    the two CLI-default caption heads served, the post-processing of the
    same forward outputs on the card and on the CPU held equal, and an
    oracle detector that must score mAP 1.0.  ``sizes`` shrinks the model
    (a CPU rehearsal); the card runs it at full width."""
    from scan2cap_torch.config import flagship_config
    from scan2cap_torch.data.synthetic import make_vocab, to_device
    from scan2cap_torch.eval.eval_helper import (eval_cap, feed_scene_cap,
                                                 postprocess_scene_cap,
                                                 score_captions)
    from scan2cap_torch.kernels import launch_counts, reset_launch_counts
    from scan2cap_torch.models import CapNet
    from scan2cap_torch.ops.nms import nms_3d
    from scan2cap_torch.train.step import make_eval_step

    dev = torch.device(dev)
    sizes = sizes or {}
    cfg = flagship_config(**sizes)
    B = 2
    vocab = make_vocab(num_vocabs=num_vocabs, emb_size=cfg.emb_size)
    batches, dataset, organized, corpus = eval_data(np, cfg, vocab, nb, B)
    model = CapNet(cfg, num_vocabs=num_vocabs, device=dev, seed=0)
    condition_weights(torch, model)
    step = make_eval_step(cfg, model)
    feed_scene_cap(step, dataset, batches[:1], organized, device=dev)

    # the main path: eval_cap, the AP loop, the two caption heads
    reset_launch_counts()
    t0 = time.perf_counter()
    scores = eval_cap(step, dataset, batches, organized, corpus=corpus,
                      device=dev)
    eval_cap_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ap, _, ap_metrics_s = ap_loop(torch, step, batches, vocab["emb_table"],
                                  dev)
    ap_ms = (time.perf_counter() - t0) * 1e3 / nb
    flagship_launches = launch_counts()
    decoders = {kind: serve_decoder(torch, np, kind, dev, sizes, num_vocabs,
                                    requests)
                for kind in ("scene_caption", "topdown_full_k")}
    launches = launch_counts()
    forwards = 2 * nb + sum(d["forwards"] for d in decoders.values())
    want = dict(furthest_point_sample_cuda=(5 * 2 * nb, 5 * forwards),
                ball_query_cuda=(5 * 2 * nb, 5 * forwards),
                group_points_cuda=(5 * 2 * nb, 5 * 2 * nb + sum(
                    d["gathers_per_forward"] * d["forwards"]
                    for d in decoders.values())))
    for w, (flag, total) in want.items():
        require(dev.type != "cuda" or (flagship_launches[w], launches[w])
                == (flag, total), f"{w}: {flagship_launches[w]} launches in "
                f"{2 * nb} flagship forwards (want {flag}), {launches[w]} in "
                f"all {forwards} forwards (want {total})")
    names = ("BLEU-1", "BLEU-2", "BLEU-3", "BLEU-4")
    metrics = dict(zip(names, scores[0][0]), CIDEr=scores[1][0],
                   ROUGE=scores[2][0], METEOR=scores[3][0])
    require(all(np.isfinite(v) for v in metrics.values()),
            f"caption metrics not finite: {metrics}")

    # the split: the host loop per batch, post-processing
    t0 = time.perf_counter()
    feed_scene_cap(step, dataset, batches, organized, device=dev)
    feed_ms = (time.perf_counter() - t0) * 1e3 / nb
    recorded = []

    def record(batch):
        out = step(batch)
        recorded.append({k: v.cpu() for k, v in out.items()})
        return out
    card_cands = feed_scene_cap(record, dataset, batches, organized,
                                device=dev)
    emb = torch.as_tensor(vocab["emb_table"]).to(dev)
    tb0 = to_device({k: v for k, v in batches[0].items()
                     if k != "glove_emb_table"}, dev)
    tb0["glove_emb_table"] = emb
    out0 = {k: v.to(dev) for k, v in recorded[0].items()}
    prob0 = torch.softmax(out0["objectness_scores"], dim=-1)[..., 1]
    cls0 = torch.argmax(out0["sem_cls_scores"], dim=-1)
    post_ms = host_ms(torch, lambda: postprocess_scene_cap(out0, tb0), 20, dev)
    nms_ms = host_ms(torch, lambda: nms_3d(out0["bbox_corner"], prob0, cls0),
                     20, dev)
    nms_device = (device_only_ms(lambda: nms_3d(out0["bbox_corner"], prob0,
                                                cls0), 10)
                  if dev.type == "cuda" else None)
    cpu = torch.device("cpu")

    def post_card_vs_cpu(outs, what):
        """Each batch's outputs post-processed on ``dev`` and on the CPU:
        every mask and id equal; the gate counts and the worst IoU error."""
        counts, worst_iou, keeps = [], 0.0, []
        for batch, rec in zip(batches, outs):
            tbs = {}
            for d in (dev, cpu):
                tb = to_device({k: v for k, v in batch.items()
                                if k != "glove_emb_table"}, d)
                tbs[d.type] = postprocess_scene_cap(
                    {k: v.to(d) for k, v in rec.items()}, tb)
            post, ref = tbs[dev.type], tbs["cpu"]
            for k in ("keep", "detected_object_ids", "captions", "nonempty",
                      "nms_mask", "final_mask"):
                require(torch.equal(post[k].cpu(), ref[k]),
                        f"{what} post-processing {k}: card != CPU")
            worst_iou = max(worst_iou, float((post["ious"].cpu()
                                              - ref["ious"]).abs().max()))
            counts.append(stage_counts(post))
            keeps.append(post["keep"].cpu().numpy())
        return counts, worst_iou, keeps

    # the same forward outputs post-processed on the CPU
    counts, worst_iou, _ = post_card_vs_cpu(recorded, "flagship")
    cpu_cands = feed_scene_cap(replay_step(recorded, cpu), dataset,
                               batches, organized, device=cpu)
    require(cpu_cands == card_cands, "candidates: card != CPU")
    ap_card, masks_card, _ = ap_loop(torch, replay_step(recorded, dev),
                                     batches, vocab["emb_table"], dev)
    ap_cpu, masks_cpu, _ = ap_loop(torch, replay_step(recorded, cpu),
                                   batches, vocab["emb_table"], cpu)
    for a, b in zip(masks_card, masks_cpu):
        for k in ("pred_mask", "pred_sem_cls"):
            require(np.array_equal(a[k], b[k]), f"parse {k}: card != CPU")
    ap_err = max(abs(ap_card[t][k] - ap_cpu[t][k])
                 for t in ap_card for k in ap_card[t])
    require(ap_err <= 1e-6, f"AP card vs CPU differ by {ap_err}")

    # the oracle: NMS removes the duplicates, mAP@0.25 reads 1.0, and every
    # GT object becomes a candidate, the same on the card and on the CPU
    oracle, kept_slots = [], []
    for batch, rec in zip(batches, recorded):
        o, slots = oracle_outputs(torch, np, batch, rec)
        oracle.append(o)
        kept_slots.append(slots)
    oracle_ap = {}
    for d in (dev, cpu):
        m, parsed, _ = ap_loop(torch, replay_step(oracle, d), batches,
                               vocab["emb_table"], d)
        for p, slots in zip(parsed, kept_slots):
            require(np.array_equal(p["pred_mask"], slots),
                    f"oracle on {d.type}: NMS kept {p['pred_mask'].sum()} "
                    f"slots, want the {slots.sum()} exact GT boxes")
        # AP and AR read npos / (npos + 1e-8), not 1, for a perfect
        # detector (utils/eval_det.py's recall)
        require(all(abs(m[t][k] - 1.0) < 1e-6 for t in m
                    for k in ("mAP", "AR")),
                f"oracle on {d.type}: mAP {m[0.25]['mAP']}, {m[0.5]['mAP']}")
        oracle_ap[d.type] = m
    oracle_counts, oracle_iou, oracle_keeps = post_card_vs_cpu(oracle,
                                                                "oracle")
    for keep, slots in zip(oracle_keeps, kept_slots):
        require(np.array_equal(keep, slots), f"oracle: keep holds "
                f"{keep.sum()} slots, want the {slots.sum()} exact GT boxes")
    t0 = time.perf_counter()
    oracle_cands = feed_scene_cap(replay_step(oracle, dev), dataset,
                                  batches, organized, device=dev)
    oracle_feed_ms = (time.perf_counter() - t0) * 1e3 / nb
    oracle_cpu_cands = feed_scene_cap(replay_step(oracle, cpu), dataset,
                                      batches, organized, device=cpu)
    objects = sum(len(v) for v in organized.values())
    require(len(oracle_cands) == objects > 0,
            f"oracle: {len(oracle_cands)} candidates for {objects} objects")
    require(oracle_cpu_cands == oracle_cands, "oracle candidates: card != CPU")
    # scoring is timed on the oracle's decoded captions: where the
    # flagship's random weights pass no proposal, its candidates are all
    # filled in as "sos eos"
    t0 = time.perf_counter()
    oracle_scores = score_captions(corpus, dict(oracle_cands))
    scoring_s = time.perf_counter() - t0
    words = [len(c[0].split()) - 2 for c in oracle_cands.values()]

    return dict(batch=B, batches=nb, num_points=cfg.num_points,
                num_proposals=cfg.num_proposals, hidden_size=cfg.hidden_size,
                vocab=num_vocabs, eval_cap_s=eval_cap_s,
                feed_ms_per_batch=feed_ms, ap_loop_ms_per_batch=ap_ms,
                ap_metrics_s=ap_metrics_s,
                scoring_s=scoring_s, scoring_candidates=len(oracle_cands),
                postprocess_ms=post_ms, nms_ms=nms_ms,
                postprocess_rest_ms=post_ms - nms_ms,
                nms_device=nms_device, counts=counts,
                candidates=len(card_cands), metrics=metrics,
                ap={str(t): dict(mAP=m["mAP"], AR=m["AR"]) for t, m in ap.items()},
                ap_card_vs_cpu_max_err=ap_err, ious_max_abs_err=worst_iou,
                oracle=dict(
                    ap={str(t): dict(mAP=m["mAP"], AR=m["AR"])
                        for t, m in oracle_ap[dev.type].items()},
                    counts=oracle_counts, ious_max_abs_err=oracle_iou,
                    candidates=len(oracle_cands),
                    words_per_caption=[min(words), max(words)],
                    feed_ms_per_batch=oracle_feed_ms,
                    CIDEr=oracle_scores[1][0]),
                decoders=decoders, forwards=forwards,
                flagship_launches_per_forward={
                    k: v / (2 * nb) for k, v in flagship_launches.items()},
                launches=launches)


# --------------------------------------------------------------------- phase 7
def run_probes(torch):
    """The probes' own entry points on the card; returns their launches."""
    from scan2cap_torch.kernels import launch_counts, reset_launch_counts
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
    probes_launches = launch_counts()
    report["large"] = run_large_scene(torch)
    report["launches"] = {k: v + report["large"]["launches"][k]
                          for k, v in probes_launches.items()}
    return report


# the flagship served on full-resolution rooms: sa1's FPS in a 16-block
# cluster
LARGE_SCENE_POINTS = 150000


def run_large_scene(torch, requests=10):
    """Above the main path's shapes: the flagship's eval forward at
    LARGE_SCENE_POINTS points (B=2, ``requests`` after a warm-up), whose
    sa1 FPS runs in a 16-block cluster, its indices held against the plain
    version and ms per batch timed; then the ops' entry points on a
    200,000-point room (FPS in the shared-state tier, the ordered first-k
    at nsample 512) and on a 400,001-point room (FPS streamed), each held
    against its plain version.  Returns the launches of both parts."""
    import numpy as np
    from scan2cap_torch.config import flagship_config
    from scan2cap_torch.data.synthetic import to_device
    from scan2cap_torch.kernels import fps, launch_counts, reset_launch_counts
    from scan2cap_torch.models import CapNet
    from scan2cap_torch.ops import grouping, sampling
    from scan2cap_torch.probes.bq_variants import room
    from scan2cap_torch.train.step import make_eval_step

    cfg = flagship_config(num_points=LARGE_SCENE_POINTS)
    require(fps.tier(fps.fps_variant(cfg.num_points)) == "cluster16",
            f"{cfg.num_points} points do not get the 16-block FPS tier")
    B = 2
    host = flagship_batch(np, cfg, B)
    model = CapNet(cfg, num_vocabs=NUM_VOCABS, device="cuda", seed=0)
    step = make_eval_step(cfg, model)
    batch = to_device(host, "cuda")
    # the warm-up request holds each kernel launch against its plain
    # version on the same inputs, sa1's FPS over all the points among them
    with HeldAgainstPlain(torch) as held:
        step(batch)
    torch.cuda.synchronize()
    require(["furthest_point_sample_cuda", [B, LARGE_SCENE_POINTS,
                                            cfg.sa_npoints[0]]]
            in [[k, shape] for k, shape in held.checked],
            f"large scene: sa1's FPS was not held, {held.checked}")
    reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(requests):
        out = step(batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / requests
    served = launch_counts()
    require(served["fps_cluster16"] == requests
            and served["furthest_point_sample_cuda"] == 5 * requests,
            f"large scene: launches {served}, want 5 FPS a forward, 1 of "
            f"them in a 16-block cluster")
    for k, v in out.items():
        if v.is_floating_point():
            require(bool(torch.isfinite(v).all()), f"large scene: {k} not "
                    f"finite")
    print(f"  large scene: {LARGE_SCENE_POINTS} points, B={B}: {ms:.2f} ms "
          f"per batch over {requests} requests", flush=True)
    del model, step, batch, out

    reset_launch_counts()
    x = torch.from_numpy(room(np.random.RandomState(4), 1, 200000)).to("cuda")
    got = sampling.furthest_point_sample(x, 2048)
    require(torch.equal(got, sampling.furthest_point_sample_plain(x, 2048)),
            "200,000 points: FPS != plain")
    q = torch.gather(x, 1, got[0, :256].long()[None, :, None].expand(
        -1, -1, 3)).contiguous()
    idx = grouping.ball_query(x, q, 0.4, 512)
    require(torch.equal(idx, grouping.ball_query_plain(x, q, 0.4, 512)),
            "200,000 points: ball query at nsample 512 != plain")
    x = torch.from_numpy(room(np.random.RandomState(5), 1, 400001)).to("cuda")
    got = sampling.furthest_point_sample(x, 256)
    require(torch.equal(got, sampling.furthest_point_sample_plain(x, 256)),
            "400,001 points: FPS != plain")
    ops = launch_counts()
    require(ops["fps_shared_state"] == 1 and ops["fps_streamed"] == 1
            and ops["ball_query_ordered"] == 1,
            f"large scenes through the ops: launches {ops}")
    return dict(num_points=LARGE_SCENE_POINTS, batch=B, requests=requests,
                ms_per_batch=ms, held_exact=len(held.checked),
                launches={k: served[k] + ops[k] for k in served})


# --------------------------------------------------------------------- phase 8
# the flagship's flags less --use_multiview (its features come from an HDF5
# file through h5py): 4 input channels over 40,000 points, 256 proposals,
# the CLI's default batch of 8
CLI_FLAGS = ("--use_normal", "--use_topdown", "--num_locals", "10",
             "--num_graph_steps", "2", "--use_relation", "--use_orientation")
CLI_SCENE_POINTS = 150000
CLI_BOXES = 12
CLI_WORDS = NUM_VOCABS - 4             # and the four specials
CLI_TRAIN_ENTRIES = 120
CLI_BATCH = 8
# warm steps of the resumed run under torch.profiler (--profile)
CLI_PROFILED_STEPS = 3
# nyu40 ids of the named classes (cabinet .. bathtub)
NAMED_NYU40 = (3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36)


def write_scannet_fixture(np, root, points=CLI_SCENE_POINTS, seed=0):
    """ScanNet-layout scenes, ScanRefer JSON, a GloVe pickle and the
    rotations file under ``root``/data, made from ``seed``: 6 train and 2
    val scenes of 150,000 points (floor and walls around 12 boxes of named
    classes, each box half a thousand points and more), 120 train entries
    whose tokens cover all 3,429 words once, 3 val entries a scene."""
    import pickle

    from scan2cap_torch.config import SCANNET_CLASS2TYPE
    from scan2cap_torch.data.dataset import DC_NYU2CLS

    rs = np.random.RandomState(seed)
    data = os.path.join(root, "data")
    scannet = os.path.join(data, "scannet", "scannet_data")
    os.makedirs(scannet)
    train = [f"scene{i:04d}_00" for i in range(6)]
    val = [f"scene{100 + i:04d}_00" for i in range(2)]
    names, rotations = {}, {}
    for sid in train + val:
        P = points
        verts = np.zeros((P, 9), np.float32)
        verts[:, 0:2] = rs.uniform(-4, 4, (P, 2))
        verts[:, 2] = rs.uniform(0, 0.05, P)
        verts[:, 3:6] = rs.randint(0, 256, (P, 3))
        normals = rs.randn(P, 3)
        verts[:, 6:9] = normals / np.linalg.norm(normals, axis=1, keepdims=True)
        ins = np.zeros(P, np.int32)
        sem = np.full(P, 2, np.int32)                      # floor
        bboxes = np.zeros((CLI_BOXES, 8), np.float32)
        per_box = P // 2 // CLI_BOXES
        for o in range(CLI_BOXES):
            lo, hi = P // 2 + o * per_box, P // 2 + (o + 1) * per_box
            center = np.float32([*rs.uniform(-3, 3, 2), rs.uniform(0.3, 1.2)])
            size = rs.uniform(0.3, 1.5, 3).astype(np.float32)
            verts[lo:hi, 0:3] = center + (rs.rand(per_box, 3) - 0.5) * size
            nyu = NAMED_NYU40[(o + len(names)) % len(NAMED_NYU40)]
            # ScanNet's layout: object o carries instance label o + 1 (0
            # is no object), its box the object id o
            ins[lo:hi] = o + 1
            sem[lo:hi] = nyu
            bboxes[o] = [*center, *size, nyu, o]
            names[(sid, o)] = SCANNET_CLASS2TYPE[DC_NYU2CLS[nyu]]
        base = os.path.join(scannet, sid)
        np.save(base + "_aligned_vert.npy", verts)
        np.save(base + "_ins_label.npy", ins)
        np.save(base + "_sem_label.npy", sem)
        np.save(base + "_aligned_bbox.npy", bboxes)
        rotations[sid] = {str(o): np.eye(3).tolist()
                          for o in range(CLI_BOXES)}
    words = [f"word{i:04d}" for i in range(CLI_WORDS)]
    glove = {w: rs.randn(300).astype(np.float32)
             for w in words + ["pad_", "unk", "sos", "eos"]}
    with open(os.path.join(data, "glove.p"), "wb") as f:
        pickle.dump(glove, f)

    def entry(sid, obj, ann, tokens):
        return {"scene_id": sid, "object_id": str(obj),
                "object_name": names[(sid, obj)].replace(" ", "_"),
                "ann_id": str(ann), "token": tokens,
                "description": " ".join(tokens)}

    train_entries = [entry(train[i % 6], (i // 6) % CLI_BOXES, i // 72,
                           words[i::CLI_TRAIN_ENTRIES])
                     for i in range(CLI_TRAIN_ENTRIES)]
    val_entries = [entry(sid, obj, 0, list(rs.choice(words, 12)))
                   for sid in val for obj in (0, 1, 2)]
    organized = {}
    for e in train_entries + val_entries:
        organized.setdefault(e["scene_id"], {}).setdefault(
            e["object_id"], {})[e["ann_id"]] = e
    for name, content in (("ScanRefer_filtered_train.json", train_entries),
                          ("ScanRefer_filtered_val.json", val_entries),
                          ("ScanRefer_filtered_organized.json", organized),
                          ("scannet_instance_rotations.json", rotations)):
        with open(os.path.join(data, name), "w") as f:
            json.dump(content, f)
    return data, train, val


def run_entry_point(module, args, env, logs):
    """``python -m module args`` to its end; its output goes to the log
    file, and a failure ends the phase with the log's tail."""
    log = os.path.join(logs, module.rsplit(".", 1)[-1] + ".log")
    t0 = time.perf_counter()
    with open(log, "a") as f:
        rc = subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT,
                            env=env, stdout=f, stderr=subprocess.STDOUT,
                            timeout=600).returncode
    wall = time.perf_counter() - t0
    with open(log) as f:
        text = f.read()
    require(rc == 0, f"{module} {' '.join(args)} exited {rc}:\n{text[-3000:]}")
    return text, wall


def getitem_ms(np, data, train, native_on, num_points=40000):
    """ms per sample of the train dataset's __getitem__ (augmented, as the
    CLI's configuration has it) on the native data plane or numpy's."""
    from scan2cap_torch import native
    from scan2cap_torch.data.dataset import ScannetReferenceDataset

    with open(os.path.join(data, "ScanRefer_filtered_train.json")) as f:
        entries = json.load(f)[:16]
    ds = ScannetReferenceDataset(
        entries, train,
        scannet_data_dir=os.path.join(data, "scannet", "scannet_data"),
        glove_path=os.path.join(data, "glove.p"), num_points=num_points,
        use_height=True, use_normal=True, augment=True)
    saved = native._lib, native._tried
    if not native_on:
        native._lib, native._tried = None, True
    try:
        ds.__getitem__(0, np.random.RandomState(0))
        t0 = time.perf_counter()
        for i in range(len(ds)):
            ds.__getitem__(i, np.random.RandomState(i))
        return (time.perf_counter() - t0) * 1e3 / len(ds)
    finally:
        native._lib, native._tried = saved


def per_call(launches, calls):
    return {k: v / calls for k, v in launches.items() if calls}


def trace_kernels(path, steps):
    """Device time (ms) and kernels per step in a ``--profile`` trace (the
    chrome trace ``torch.profiler`` exports: GPU kernels are the events of
    category "kernel", their "dur" in microseconds)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    return dict(kernel_ms=sum(e["dur"] for e in kernels) / 1e3 / steps,
                kernels=len(kernels) / steps)


def cli_phase(torch, np, card, dev="cuda", rehearse=False):
    """The port's own entry points as subprocesses on ``dev``, on
    ScanNet-layout fixture data at full scale: train one epoch (the
    in-training eval fires at its last step), resume to epoch 2, evaluate
    captions and detection, write benchmark predictions.  ``rehearse``
    shrinks scenes and model for a run on the CPU (``SCAN2CAP_TEST_TINY``,
    1,024 points, 32 proposals); launches are then not counted."""
    import shutil
    import tempfile

    from scan2cap_torch import convert, native
    from scan2cap_torch.models import CapNet
    from scan2cap_torch.scripts.train import model_config_from_info
    from scan2cap_torch.train.checkpoints import CheckpointIO

    require(native.available(), "the native data plane did not build")
    root = tempfile.mkdtemp(prefix="scan2cap_cli_")
    logs = os.path.join(ROOT, "chiprun_out", "cli")
    os.makedirs(logs, exist_ok=True)
    try:
        t0 = time.perf_counter()
        data, train, val = write_scannet_fixture(
            np, root, points=3000 if rehearse else CLI_SCENE_POINTS)
        fixture_s = time.perf_counter() - t0
        num_points = 1024 if rehearse else 40000
        native_ms = getitem_ms(np, data, train, True, num_points)
        numpy_ms = getitem_ms(np, data, train, False, num_points)
        out = os.path.join(root, "outputs")
        env = dict(os.environ, SCAN2CAP_DATA=data, SCAN2CAP_OUTPUT=out,
                   PYTHONPATH=ROOT)
        env.pop("SCAN2CAP_TEST_TINY", None)
        flags = [*CLI_FLAGS, "--device", dev]
        if rehearse:
            env["SCAN2CAP_TEST_TINY"] = "1"
            flags += ["--num_points", "1024", "--num_proposals", "32"]
        steps = CLI_TRAIN_ENTRIES // CLI_BATCH
        walls = {}
        _, walls["train"] = run_entry_point(
            "scan2cap_torch.scripts.train",
            [*flags, "--epoch", "1", "--val_step", str(steps),
             "--verbose", "1", "--tag", "smoke_a"], env, logs)
        run_a = next(d for d in os.listdir(out) if d.endswith("_SMOKE_A"))
        text, walls["resume"] = run_entry_point(
            "scan2cap_torch.scripts.train",
            [*flags, "--epoch", "2", "--val_step", "1000", "--verbose",
             "1", "--profile", str(CLI_PROFILED_STEPS), "--use_checkpoint",
             run_a, "--tag", "smoke_b"], env, logs)
        # the CLI counts epochs from 0, its log from 1: "epoch 2 starting"
        require(f"resumed from {run_a} at epoch 1" in text,
                "the resume did not start at global epoch 2")
        run_b = next(d for d in os.listdir(out) if d.endswith("_SMOKE_B"))
        text, walls["eval"] = run_entry_point(
            "scan2cap_torch.scripts.eval",
            ["--folder", run_b, "--eval_caption", "--eval_detection",
             "--device", dev], env, logs)
        for tag in ("[BLEU-4]", "[CIDEr]", "[ROUGE]", "[METEOR]",
                    "mAP@0.25", "mAP@0.5"):
            require(tag in text, f"eval printed no {tag}")
        _, walls["predict"] = run_entry_point(
            "scan2cap_torch.benchmark.predict",
            ["--folder", run_b, "--device", dev], env, logs)
        # the offline flow of launch/benchmark.sh: GT boxes, then the scorer
        _, walls["build_benchmark_gt"] = run_entry_point(
            "scan2cap_torch.scripts.build_benchmark_gt",
            ["--split", "val", "--data", data], env, logs)
        _, walls["benchmark_eval"] = run_entry_point(
            "scan2cap_torch.benchmark.eval",
            ["--path", os.path.join(out, run_b, "pred.json"), "--gt_path",
             os.path.join(data, "ScanRefer_filtered_val_gt_bbox.json"),
             "--device", dev], env, logs)

        def read(run, name):
            with open(os.path.join(out, run, name)) as f:
                return f.read() if name.endswith(".txt") else json.load(f)

        log_a, log_b = read(run_a, "log.txt"), read(run_b, "log.txt")
        require(f"[eval @ iter {steps}]" in log_a,
                "the in-training eval did not fire")
        require("epoch 2 starting..." in log_b
                and "epoch 1 starting..." not in log_b,
                "the resumed run did not run global epoch 2 alone")
        stats_a = read(run_a, "train_stats.json")
        stats_b = read(run_b, "train_stats.json")
        losses = [x for st in (stats_a, stats_b) for e in st["epochs"]
                  for x in e["losses"]]
        require(len(losses) == 2 * steps and all(np.isfinite(losses)),
                f"train losses: {losses}")
        ckpt = CheckpointIO(os.path.join(out, run_b, "ckpt"))
        resume = ckpt.restore("resume")
        opt_steps = {int(v["step"]) for v in
                     resume["optimizer"]["state"].values()}
        require(resume["epoch"] == 1 and resume["step"] == 2 * steps
                and opt_steps == {2 * steps},
                f"resume bundle: epoch {resume['epoch']}, step "
                f"{resume['step']}, optimizer steps {opt_steps}")

        # last.pt into a fresh model on the card, and through the
        # reference's layout, bit-equal
        last = ckpt.restore("last")["model"]
        info = read(run_b, "info.json")
        os.environ.update({k: env[k] for k in ("SCAN2CAP_TEST_TINY",)
                           if k in env})
        model = CapNet(model_config_from_info(info),
                       num_vocabs=NUM_VOCABS, device=dev, seed=1)
        os.environ.pop("SCAN2CAP_TEST_TINY", None)
        model.load_state_dict(last, strict=True)
        require(all(torch.equal(v.cpu(), last[k])
                    for k, v in model.state_dict().items()),
                "last.pt does not load bit-equal")
        pth = os.path.join(root, "model.pth")
        torch.save(convert.reference_from_state_dict(last), pth)
        back = convert.state_dict_from_reference(pth)
        require(set(back) == set(last) and all(
            torch.equal(back[k], last[k]) for k in last),
            "the reference-layout export does not reload bit-equal")

        preds = read(run_b, "pred.json")
        require(set(preds) == set(val), f"pred.json covers {sorted(preds)}")
        scored = read(run_b, "eval_results.json")
        require({"captioning", "detection", "densecap"} <= set(scored),
                f"eval_results.json holds {sorted(scored)}")

        # launches: per train step and per eval forward, the structure's
        bb = model.backbone_net
        sa = (bb.sa1, bb.sa2, bb.sa3, bb.sa4, model.proposal.vote_aggregation)
        gathers = sum(1 if m.gather_lean else 2 for m in sa)
        backward = int(bb.sa1.gather_lean and bb.sa1.leaf_inputs)
        want_step = dict(furthest_point_sample_cuda=5, ball_query_cuda=5,
                         group_points_cuda=gathers + backward)
        want_forward = dict(furthest_point_sample_cuda=5, ball_query_cuda=5,
                            group_points_cuda=gathers)
        ev, pr = read(run_b, "eval_stats.json"), read(run_b, "predict_stats.json")
        per = dict(
            train_step=per_call(stats_a["launches"], stats_a["steps"]),
            resume_step=per_call(stats_b["launches"], stats_b["steps"]),
            eval_caption_forward=per_call(ev["caption"]["launches"],
                                          ev["caption"]["batches"]),
            eval_detection_forward=per_call(ev["detection"]["launches"],
                                            ev["detection"]["batches"]),
            predict_forward=per_call(pr["predict"]["launches"],
                                     pr["predict"]["batches"]))
        for what, counts in per.items():
            want = want_step if what.endswith("step") else want_forward
            for k, v in want.items():
                require(rehearse or counts.get(k) == v,
                        f"{what}: {k} {counts.get(k)} launches, the "
                        f"structure's is {v}")
        launches = {}
        for counts in (stats_a["launches"], stats_b["launches"],
                       ev["caption"]["launches"], ev["detection"]["launches"],
                       pr["predict"]["launches"]):
            for k, v in counts.items():
                launches[k] = launches.get(k, 0) + v

        step_s = sorted(stats_a["epochs"][0]["step_s"][2:])
        step_ms = step_s[len(step_s) // 2] * 1e3
        profile = trace_kernels(os.path.join(out, run_b, "profile",
                                             "trace.json"), CLI_PROFILED_STEPS)
        require(rehearse or profile["kernels"] > 0,
                "the --profile trace of the resumed run holds no kernel")
        profile["busy_share_of_step"] = profile["kernel_ms"] / step_ms
        resume_s = sorted(stats_b["epochs"][0]["step_s"][2:])
        fetch = sorted(stats_a["epochs"][0]["fetch_s"])
        return dict(
            card=card, config=" ".join(flags), batch=CLI_BATCH,
            scene_points=3000 if rehearse else CLI_SCENE_POINTS,
            vocab=NUM_VOCABS,
            train_scenes=len(train), val_scenes=len(val),
            train_entries=CLI_TRAIN_ENTRIES, steps_per_epoch=steps,
            train_ms_per_step=step_ms, scenes_per_s=CLI_BATCH / step_ms * 1e3,
            resume_ms_per_step=resume_s[len(resume_s) // 2] * 1e3,
            step_ms_all=[x * 1e3 for x in stats_a["epochs"][0]["step_s"]],
            fetch_s_median=fetch[len(fetch) // 2], fetch_s_max=fetch[-1],
            fetch_s=stats_a["epochs"][0]["fetch_s"],
            getitem_ms_native=native_ms, getitem_ms_numpy=numpy_ms,
            native_available=native.available(),
            checkpoint_save_ms=[x * 1e3 for x in
                                stats_a["save_s"] + stats_b["save_s"]],
            eval_caption_ms_per_batch=(ev["caption"]["s"] * 1e3
                                       / ev["caption"]["batches"]),
            eval_detection_ms_per_batch=(ev["detection"]["s"] * 1e3
                                         / ev["detection"]["batches"]),
            predict_ms_per_batch=(pr["predict"]["s"] * 1e3
                                  / pr["predict"]["batches"]),
            losses=losses, launches_per_call=per, launches=launches,
            profile=profile,
            entry_point_wall_s=walls, fixture_s=fixture_s,
            predictions={k: len(v) for k, v in preds.items()},
            benchmark=dict(
                detection_map={t: scored["detection"][t]["mAP"]
                               for t in ("0.25", "0.5")},
                densecap_map=scored["densecap"]["mAP"],
                cider_f1_at_05=scored["captioning"]["0.5"]["f1-score"][
                    "cider"]))
    finally:
        shutil.rmtree(root, ignore_errors=True)


# --------------------------------------------------------------------- phase 9
# launch/train_maskvotenet.sh: B=16, multiview + normal + height and the
# mask channel, 136 columns with xyz
MVN_BATCH = 16
# step 1's card-against-CPU check at full width, at a smaller batch: the
# CPU's step at B=16 takes minutes; the indices at B=16 are held exactly
# against the plain versions on the card instead (HeldAgainstPlain)
MVN_PARITY_BATCH = 4
# the entry point's run on the CLI fixture: --use_normal (no multiview:
# its features come from an HDF5 file through h5py), two epochs
MVN_CLI_EPOCHS = 2


def mvn_config(**overrides):
    from scan2cap_torch.config import ModelConfig
    base = dict(num_points=40000, num_proposals=1, max_num_obj=1,
                use_normal=True, use_multiview=True, no_caption=True)
    base.update(overrides)
    return ModelConfig(**base)


def mvn_batch(np, cfg, B, seed=0):
    """A synthetic MaskVoteNet batch (host arrays): seeded normals and
    multiview features in place of the zeros."""
    from scan2cap_torch.data.synthetic import make_mask_votenet_batch
    host = make_mask_votenet_batch(cfg, B, num_objects=8, seed=seed)
    rs = np.random.RandomState(1 + seed)
    pc = host["point_clouds"]
    pc[..., 3:3 + 131] = rs.randn(B, cfg.num_points, 131).astype(np.float32) * 0.1
    require(pc.shape == (B, cfg.num_points, 136), f"MaskVoteNet input {pc.shape}")
    return host


def mvn_launches_right(per_step, where):
    """5 FPS and 5 first-k per step, 1 of them through the ordered scan (the
    aggregation's nsample 512), 6 gathers."""
    want = dict(furthest_point_sample_cuda=5, ball_query_cuda=5,
                ball_query_ordered=1, group_points_cuda=6)
    for k, v in want.items():
        require(per_step.get(k) == v, f"{where}: {k} {per_step.get(k)} "
                f"launches per step, want {v}")


class HeldAgainstPlain:
    """While open, every launch of the path's three kernels through
    ``scan2cap_torch.ops`` (FPS, the first-k ball query, the row gather)
    is held against its plain version on the same inputs on the card, and
    must equal it exactly; ``checked`` lists (kernel, shape) per launch.
    The plain versions launch no wrapper, so the counts stay the path's."""

    def __init__(self, torch):
        from scan2cap_torch.ops import grouping, sampling
        self.torch, self.grouping, self.sampling = torch, grouping, sampling
        self.checked = []

    def fps(self, xyz, npoint, **kw):
        got = self.kernels["fps"](xyz, npoint, **kw)
        want = self.sampling.furthest_point_sample_plain(xyz, npoint)
        self._hold("furthest_point_sample_cuda", got, want,
                   [*xyz.shape[:2], npoint])
        return got

    def first_k(self, xyz, new_xyz, r2, nsample, **kw):
        got = self.kernels["first_k"](xyz, new_xyz, r2, nsample, **kw)
        radius = float(r2) ** 0.5
        require(self.grouping.radius_squared(radius) == r2,
                f"radius {radius} does not give back r2 {r2}")
        want = self.grouping.ball_query_plain(xyz, new_xyz, radius, nsample)
        self._hold("ball_query_cuda", got, want,
                   [xyz.shape[0], xyz.shape[1], new_xyz.shape[1], nsample])
        return got

    def gather(self, features, idx, **kw):
        got = self.kernels["gather"](features, idx, **kw)
        want = self.grouping.group_points_plain(features, idx)
        self._hold("group_points_cuda", got, want,
                   [*features.shape, *idx.shape[1:]])
        return got

    def _hold(self, kernel, got, want, shape):
        require(self.torch.equal(got, want), f"{kernel} at {shape} on the "
                f"path: kernel != plain")
        self.checked.append((kernel, shape))

    def __enter__(self):
        g, s = self.grouping, self.sampling
        self.saved = dict(fps=s.furthest_point_sample_cuda,
                          first_k=g.ball_query_cuda,
                          gather=g.group_points_cuda)
        self.kernels = dict(self.saved)
        s.furthest_point_sample_cuda = self.fps
        g.ball_query_cuda, g.group_points_cuda = self.first_k, self.gather
        return self

    def __exit__(self, *exc):
        s, g, k = self.sampling, self.grouping, self.saved
        s.furthest_point_sample_cuda = k["fps"]
        g.ball_query_cuda, g.group_points_cuda = k["first_k"], k["gather"]


def train_mask_votenet(torch, np, dev="cuda", cfg=None, B=MVN_BATCH,
                       parity_batch=MVN_PARITY_BATCH, warmup=2, steps=5,
                       windows=3, lr=1e-3, bn_momentum=0.1):
    """MaskVoteNet's train step at the launch script's width on a repeated
    synthetic batch: step 2 with every kernel launch held against its plain
    version on the card, step 1 of a fresh model at ``parity_batch``
    against the port on the CPU, launches per step, ms per step over
    ``windows`` spans, a profiled step.  ``dev="cpu"`` rehearses the
    control flow (no kernels, no launch counts, no profile)."""
    from scan2cap_torch.data.synthetic import to_device
    from scan2cap_torch.kernels import launch_counts, reset_launch_counts
    from scan2cap_torch.models.mask_votenet import MaskVoteNet
    from scan2cap_torch.train.step import (MVN_REPORT_KEYS, create_train_state,
                                           make_mask_votenet_step)

    card = dev != "cpu"
    cfg = cfg or mvn_config()
    host = mvn_batch(np, cfg, B)
    batch = to_device(host, dev)

    def build(device):
        model = MaskVoteNet(cfg, device=device, seed=0)
        state = create_train_state(cfg, model)
        return model, state, make_mask_votenet_step(cfg, state)

    def sync():
        if card:
            torch.cuda.synchronize()

    model, state, step = build(dev)
    agg = model.proposal.vote_aggregation
    require(model.backbone_net.sa1.gather_lean and agg.nsample == 512,
            "MaskVoteNet's sa1 must be gather-lean at 133 channels and its "
            "aggregation take 512 samples")
    if card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    first = step(batch, lr, bn_momentum)                  # step 1
    sync()
    first_ms = (time.perf_counter() - t0) * 1e3
    first = {k: float(v) for k, v in first.items()}
    dev_norms = grad_norms(model)
    require(set(first) == set(MVN_REPORT_KEYS), f"metrics {sorted(first)}")
    require(all(np.isfinite(v) for v in first.values()),
            f"step 1 metrics not finite: {first}")
    require(first["vote_loss"] > 0 and first["box_loss"] > 0
            and 0 <= first["miou"] <= 1, f"degenerate training batch: {first}")

    cpu_ref = held_report = None
    if card:
        # step 2: every FPS, first-k and gather launch of a whole step at
        # B=16 (forward and backward) against its plain version on the same
        # inputs on the card, exactly
        with HeldAgainstPlain(torch) as held:
            step(batch, lr, bn_momentum)
        sync()
        by_kernel = {}
        for kernel, _ in held.checked:
            by_kernel[kernel] = by_kernel.get(kernel, 0) + 1
        ordered = sum(1 for k, shape in held.checked
                      if k == "ball_query_cuda" and shape[-1] == 512)
        require(by_kernel == dict(furthest_point_sample_cuda=5,
                                  ball_query_cuda=5, group_points_cuda=6)
                and ordered == 1, f"MaskVoteNet step held against the plain "
                f"versions: {by_kernel}, {ordered} at nsample 512")
        held_report = dict(batch=B, exact=len(held.checked),
                           by_kernel=by_kernel,
                           shapes=[[k, shape] for k, shape in held.checked])

        # step 1 of a fresh model on the card and on the CPU at
        # parity_batch: the same weights and batch, the CPU through the
        # port's plain versions, at full width
        small = mvn_batch(np, cfg, parity_batch)
        p_model, _, p_step = build(dev)
        p_first = {k: float(v) for k, v in
                   p_step(to_device(small, dev), lr, bn_momentum).items()}
        p_norms = grad_norms(p_model)
        del p_model, p_step
        t0 = time.perf_counter()
        cpu_model, _, cpu_step = build("cpu")
        cpu_first = {k: float(v) for k, v in
                     cpu_step(to_device(small, "cpu"), lr, bn_momentum).items()}
        cpu_norms = grad_norms(cpu_model)
        cpu_ms = (time.perf_counter() - t0) * 1e3
        del cpu_model, cpu_step
        loss_rel, worst_name, worst_rel = step1_parity(
            np, p_first, cpu_first, p_norms, cpu_norms, "MaskVoteNet")
        cpu_ref = dict(batch=parity_batch, num_points=cfg.num_points,
                       ms=cpu_ms, loss=cpu_first["loss"],
                       miou=cpu_first["miou"], loss_rel_err=loss_rel,
                       worst_grad_norm_rel_err=worst_rel,
                       worst_grad_norm_tensor=worst_name,
                       tensors=len(cpu_norms))
    else:
        step(batch, lr, bn_momentum)

    for _ in range(warmup - 2):
        step(batch, lr, bn_momentum)
    sync()
    reset_launch_counts()
    window_ms, losses, mious = [], [], []
    for _ in range(windows):
        t0 = time.perf_counter()
        span = [step(batch, lr, bn_momentum) for _ in range(steps)]
        sync()
        window_ms.append((time.perf_counter() - t0) * 1e3 / steps)
        losses += [float(m["loss"]) for m in span]
        mious += [float(m["miou"]) for m in span]
    taken = steps * windows
    launches = launch_counts()
    per_step = {k: v / taken for k, v in launches.items()}
    if card:
        mvn_launches_right(per_step, "MaskVoteNet train step")
    require(all(np.isfinite(v) for v in losses + mious),
            f"loss or miou not finite: {losses} {mious}")
    # the single proposal's centre loss swings from step to step early on:
    # the mean of the last five steps must lie below the first five's
    require(np.mean(losses[-5:]) < min(np.mean(losses[:5]), first["loss"]),
            f"MaskVoteNet loss did not fall on a repeated batch: {losses}")
    ms = sorted(window_ms)[len(window_ms) // 2]
    report = dict(batch=B, num_points=cfg.num_points,
                  input_columns=int(host["point_clouds"].shape[-1]),
                  sa_npoints=list(cfg.sa_npoints), lr=lr,
                  bn_momentum=bn_momentum, steps_per_window=steps,
                  window_ms_per_step=window_ms, ms_per_step=ms,
                  ms_spread=max(window_ms) - min(window_ms),
                  scenes_per_s=B / ms * 1e3, first_step_ms=first_ms,
                  launches_per_step=per_step, launches=launches,
                  step1=first, loss_by_step=losses, miou_by_step=mious,
                  held_against_plain=held_report, cpu_reference=cpu_ref)
    if card:
        # device busy share: summed kernel time of one profiled step
        profile = profile_step(lambda: step(batch, lr, bn_momentum),
                               "MaskVoteNet training")
        profile["busy_share_of_steady_step"] = profile["kernel_ms"] / ms
        report.update(profile=profile,
                      peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    return report


def mask_getitem_ms(np, data, train, num_points):
    """ms per sample of the mask dataset's __getitem__ (augmented, numpy:
    the JAX package's subclass has no native path)."""
    from scan2cap_torch.data.dataset_maskvotenet import (
        MaskScannetReferenceDataset)

    with open(os.path.join(data, "ScanRefer_filtered_train.json")) as f:
        entries = json.load(f)
    ds = MaskScannetReferenceDataset(
        entries, train,
        scannet_data_dir=os.path.join(data, "scannet", "scannet_data"),
        glove_path=os.path.join(data, "glove.p"), num_points=num_points,
        use_height=True, use_normal=True, augment=True)
    ds.__getitem__(0, np.random.RandomState(0))
    n = min(16, len(ds))
    t0 = time.perf_counter()
    for i in range(n):
        ds.__getitem__(i, np.random.RandomState(i))
    return (time.perf_counter() - t0) * 1e3 / n


def mvn_cli(torch, np, card, dev="cuda", rehearse=False):
    """``python -m scan2cap_torch.scripts.train_maskvotenet`` as a
    subprocess on the CLI phase's ScanNet-layout fixture at B=16 with
    --use_normal, two epochs: every loss finite, launches per step the
    structure's, last.pt and its reference-layout export reloaded
    bit-equal.  ``rehearse`` shrinks scenes and model for the CPU."""
    import shutil
    import tempfile

    from scan2cap_torch import convert
    from scan2cap_torch.models.mask_votenet import MaskVoteNet
    from scan2cap_torch.scripts.train_maskvotenet import (
        model_config_from_args)
    from scan2cap_torch.train.checkpoints import CheckpointIO

    root = tempfile.mkdtemp(prefix="scan2cap_mvn_")
    logs = os.path.join(ROOT, "chiprun_out", "mvn")
    os.makedirs(logs, exist_ok=True)
    try:
        data, train, _ = write_scannet_fixture(
            np, root, points=3000 if rehearse else CLI_SCENE_POINTS)
        num_points = 2048 if rehearse else 40000
        getitem = mask_getitem_ms(np, data, train, num_points)
        out = os.path.join(root, "outputs")
        env = dict(os.environ, SCAN2CAP_DATA=data, SCAN2CAP_OUTPUT=out,
                   PYTHONPATH=ROOT)
        env.pop("SCAN2CAP_TEST_TINY", None)
        args = ["--batch_size", str(MVN_BATCH), "--use_normal", "--epoch",
                str(MVN_CLI_EPOCHS), "--verbose", "1", "--num_points",
                str(num_points), "--tag", "smoke_mvn", "--device", dev]
        if rehearse:
            env["SCAN2CAP_TEST_TINY"] = "1"
        _, wall = run_entry_point("scan2cap_torch.scripts.train_maskvotenet",
                                  args, env, logs)
        run = next(d for d in os.listdir(out) if d.endswith("_SMOKE_MVN"))
        with open(os.path.join(out, run, "train_stats.json")) as f:
            stats = json.load(f)
        with open(os.path.join(out, run, "info.json")) as f:
            info = json.load(f)
        losses = [x for e in stats["epochs"] for x in e["losses"]]
        steps = len(losses)
        require(steps == stats["steps"] > 0 and all(np.isfinite(losses)),
                f"MaskVoteNet CLI losses: {losses}")
        per_step = per_call(stats["launches"], stats["steps"])
        if not rehearse:
            mvn_launches_right(per_step, "the MaskVoteNet entry point")

        # last.pt into a fresh model on the card, and through the
        # reference's layout, bit-equal
        ckpt = CheckpointIO(os.path.join(out, run, "ckpt"))
        last = ckpt.restore("last")["model"]
        os.environ.update({k: env[k] for k in ("SCAN2CAP_TEST_TINY",)
                           if k in env})
        cfg = model_config_from_args(argparse.Namespace(**info))
        os.environ.pop("SCAN2CAP_TEST_TINY", None)
        model = MaskVoteNet(cfg, device=dev, seed=1)
        model.load_state_dict(last, strict=True)
        require(all(torch.equal(v.cpu(), last[k])
                    for k, v in model.state_dict().items()),
                "MaskVoteNet last.pt does not load bit-equal")
        pth = os.path.join(root, "mask_votenet.pth")
        torch.save(convert.reference_from_state_dict(last), pth)
        require(convert.is_detection_only(convert.load_reference(pth)),
                "a MaskVoteNet .pth must read as detection weights")
        back = convert.state_dict_from_reference(pth)
        require(set(back) == set(last) and all(
            torch.equal(back[k], last[k]) for k in last),
            "the MaskVoteNet reference-layout export does not reload "
            "bit-equal")
        resume = ckpt.restore("resume")
        require(resume["epoch"] == MVN_CLI_EPOCHS - 1
                and resume["step"] == steps,
                f"MaskVoteNet resume bundle: epoch {resume['epoch']}, step "
                f"{resume['step']}")
        step_s = sorted(x for e in stats["epochs"] for x in e["step_s"][2:])
        fetch = sorted(x for e in stats["epochs"] for x in e["fetch_s"])
        return dict(
            card=card, batch=MVN_BATCH, num_points=num_points,
            num_train=info["num_train"], steps=steps,
            ms_per_iteration=step_s[len(step_s) // 2] * 1e3,
            step_ms_all=[x * 1e3 for e in stats["epochs"]
                         for x in e["step_s"]],
            fetch_s_median=fetch[len(fetch) // 2], fetch_s_max=fetch[-1],
            getitem_ms=getitem, checkpoint_save_ms=[
                x * 1e3 for x in stats["save_s"]],
            losses=losses, launches_per_step=per_step,
            launches=stats["launches"], entry_point_wall_s=wall)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def mvn_phase(torch, np, card):
    """Phase 9: MaskVoteNet in process at full width, then its entry
    point."""
    t0 = time.perf_counter()
    train = train_mask_votenet(torch, np)
    print(f"  mvn: {train['ms_per_step']:.1f} ms per step at B={train['batch']} "
          f"(spans {[round(x, 2) for x in train['window_ms_per_step']]}), "
          f"first step {train['first_step_ms']:.0f} ms, kernels "
          f"{train['profile']['kernel_ms']:.2f} ms per step (busy "
          f"{train['profile']['busy_share_of_steady_step']:.3f}), launches "
          f"per step {train['launches_per_step']}; step 2's "
          f"{train['held_against_plain']['exact']} launches at "
          f"B={train['batch']} equal to the plain versions "
          f"({train['held_against_plain']['by_kernel']}); step-1 parity "
          f"{train['cpu_reference']}", flush=True)
    train["phase_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cli = mvn_cli(torch, np, card)
    cli["phase_s"] = time.perf_counter() - t0
    print(f"  mvn cli: {cli['ms_per_iteration']:.1f} ms per iteration at "
          f"B={cli['batch']}, fetch {cli['fetch_s_median']:.4f} s, "
          f"__getitem__ {cli['getitem_ms']:.1f} ms, saves "
          f"{[round(x) for x in cli['checkpoint_save_ms']]} ms, launches per "
          f"step {cli['launches_per_step']}", flush=True)
    launches = {k: train["launches"].get(k, 0) + cli["launches"].get(k, 0)
                for k in train["launches"]}
    return dict(train=train, cli=cli, launches=launches)


# -------------------------------------------------------------------- phase 10
# tests/test_benchmark_fixture.py's pinned values of benchmark_mini
# (key path, value, tolerance); the METEOR ones hold for the built-in scorer
BENCHMARK_MINI = os.path.join(ROOT, "tests", "fixtures", "benchmark_mini")
BENCHMARK_PINS = (
    (("detection", 0.25, "mAP"), 5 / 9, 1e-6),
    (("detection", 0.5, "mAP"), 4 / 9, 1e-6),
    (("detection", 0.25, "chair Average Precision"), 1.0, 1e-6),
    (("detection", 0.5, "table Average Precision"), 0.0, 0.0),
    (("detection", 0.25, "AR"), 1.0, 1e-6),
    (("detection", 0.5, "AR"), 2 / 3, 1e-6),
    (("captioning", 0, "f1-score", "cider"), 2.428363298459073, 1e-9),
    (("captioning", 0, "f1-score", "bleu", 3), 0.28573063340795246, 1e-9),
    (("captioning", 0, "f1-score", "rouge"), 0.6220915686765073, 1e-9),
    (("captioning", 0.5, "f1-score", "cider"), 2.4089519423061985, 1e-9),
    (("captioning", 0.5, "f1-score", "rouge"), 0.5, 1e-9),
    (("captioning", 0.5, "precision", "bleu", 0), 0.4374999998975696, 1e-9),
    (("captioning", 0.5, "recall", "cider"), 2.8104439326905646, 1e-9),
)
METEOR_PINS = (
    (("captioning", 0, "f1-score", "meteor"), 0.5714853036874351, 1e-9),
    (("captioning", 0.5, "f1-score", "meteor"), 0.4864111796982168, 1e-9),
    (("densecap", "mAP"), 0.6, 1e-6),
) + tuple((("densecap", "AP", iou, m), v, 1e-6)
          for iou in (0.1, 0.2, 0.3, 0.4, 0.5)
          for m, v in ((0.15, 2 / 3), (0.75, 1 / 3)))


def _flat(d, prefix=()):
    if isinstance(d, dict):
        return {k: v for key, val in d.items()
                for k, v in _flat(val, prefix + (key,)).items()}
    if isinstance(d, (list, tuple)):
        return {k: v for i, val in enumerate(d)
                for k, v in _flat(val, prefix + (i,)).items()}
    return {prefix: d}


def benchmark_phase(torch, np, dev="cuda"):
    """Phase 10: the offline scorer on benchmark_mini with NMS and the
    rotated assignment on ``dev``: equal to the CPU's results within 1e-6
    and to the pinned values; seconds per stage on ``dev``."""
    from scan2cap_torch.eval import benchmark

    with open(os.path.join(BENCHMARK_MINI, "pred.json")) as f:
        pred = json.load(f)
    with open(os.path.join(BENCHMARK_MINI, "gt_bbox.json")) as f:
        gt = json.load(f)
    report = dict(meteor_backend=benchmark.SENTENCE_METEOR_BACKEND)
    predictions = benchmark.organize_prediction(pred)
    gts = benchmark.organize_gt(gt)
    stages = {}
    for name, fn in (
            ("assignment", lambda: benchmark.assign_pred_to_gt(
                predictions, gts, False, dev)),
            ("assignment_rotated", lambda: benchmark.assign_pred_to_gt(
                predictions, gts, True, dev)),
            ("captioning", lambda: benchmark.evaluate_captioning(
                predictions, gts, device=dev)),
            ("detection", lambda: benchmark.evaluate_detection(
                predictions, gts, device=dev)),
            ("densecap", lambda: benchmark.evaluate_dense_captioning(
                predictions, gts))):
        fn()                                   # first call: builds, caches
        t0 = time.perf_counter()
        fn()
        stages[name] = time.perf_counter() - t0
    report["stage_s"] = stages
    for rotated in (False, True):
        got = _flat(benchmark.evaluate(pred, gt, verbose=False,
                                       rotated_boxes=rotated, device=dev))
        want = _flat(benchmark.evaluate(pred, gt, verbose=False,
                                        rotated_boxes=rotated, device="cpu"))
        require(set(got) == set(want), "benchmark: result keys differ")
        worst = max(abs(float(got[k]) - float(want[k]))
                    for k in want if not isinstance(want[k], str))
        require(worst <= 1e-6, f"benchmark (rotated={rotated}): {dev} and "
                f"CPU results differ by {worst}")
        report[f"max_abs_diff_vs_cpu{'_rotated' if rotated else ''}"] = worst
        pins = BENCHMARK_PINS + (
            METEOR_PINS if benchmark.SENTENCE_METEOR_BACKEND != "nltk-wordnet"
            else ())
        for path, value, tol in pins:
            require(abs(float(got[path]) - value) <= tol,
                    f"benchmark (rotated={rotated}): {path} {got[path]}, "
                    f"pinned {value}")
        report["pins_checked"] = len(pins)
    report["detection_map"] = {str(t): got[("detection", t, "mAP")]
                               for t in (0.25, 0.5)}
    report["densecap_map"] = got[("densecap", "mAP")]
    return report


def print_eval(r):
    """The eval phase's readings, one line each."""
    for i, c in enumerate(r["counts"]):
        print(f"  eval batch {i}: nonempty {c['nonempty']}, after NMS "
              f"{c['after_nms']}, after objectness {c['after_objectness']}, "
              f"past the IoU gate {c['past_iou_gate']}", flush=True)
    print(f"  eval: {r['feed_ms_per_batch']:.2f} ms per batch (forward, "
          f"post-processing, host loop), AP loop {r['ap_loop_ms_per_batch']:.2f} "
          f"ms per batch, scoring {r['scoring_s']:.3f} s over "
          f"{r['scoring_candidates']} oracle captions, post-processing "
          f"{r['postprocess_ms']:.3f} ms of which NMS {r['nms_ms']:.3f} ms "
          f"({r['nms_device']}); AP metrics {r['ap_metrics_s']:.3f} s; mAP "
          f"{r['ap']}; oracle {r['oracle']['ap']}",
          flush=True)
    o = r["oracle"]
    print(f"  oracle: {o['feed_ms_per_batch']:.2f} ms per batch of replayed "
          f"outputs (post-processing, host loop), {o['candidates']} "
          f"candidates of {o['words_per_caption']} words, counts "
          f"{o['counts']}", flush=True)
    for kind, d in r["decoders"].items():
        print(f"  {kind}: {d['ms_per_batch']:.2f} ms per batch, tokens "
              f"{d['lang_cap_agreement']:.4f} equal to the CPU's, profile "
              f"{d['profile']}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel checks (phase 3)")
    ap.add_argument("--skip", nargs="+", default=[],
                    choices=["serve", "train", "eval", "probes", "cli",
                             "mvn", "benchmark"],
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
    from scan2cap_torch.kernels import (_build, launch_counts,
                                        reset_launch_counts)

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
    # the probes' product is on the tensor cores, its accumulator in
    # registers: a spill would put it in memory
    probe_built = [k for k in resources["pack_probe"]
                   if "probe_kernel" in k["name"]]
    require(probe_built, "the build log holds no pack probe kernel")
    spilled = [k["name"] for k in probe_built
               if k.get("spill_stores") or k.get("spill_loads")]
    require(not spilled, f"pack probe kernels spill registers: {spilled}")
    # the ball query's variants on a path (the main path's, and the ordered
    # scan's at sa1's shape and at MaskVoteNet's aggregation) must keep
    # their queries in registers; another variant that spills is reported
    from scan2cap_torch.kernels import ballquery
    from scan2cap_torch.probes import cases
    on_path = {ballquery.bq_variant(N, M, s)
               for _, N, M, _, s in BQ_SITES + BQ_ORDERED_SITES}
    on_path.add(ballquery.bq_variant(cases.MVN_VOTES, 1, cases.MVN_NSAMPLE))
    built = {ballquery.kernel_of_name(k["name"]): k
             for k in resources["ballquery"]}
    built.pop(None, None)
    spilled = sorted(key for key, k in built.items()
                     if k.get("spill_stores") or k.get("spill_loads"))
    print("ball query (variant, pack) kernels that spill: "
          f"{spilled or 'none'}", flush=True)
    for v in on_path:
        for pack in (False, True):
            require((v, pack) in built or not ballquery.takes(v, 1, pack),
                    f"the build log holds no ball-query kernel of variant "
                    f"{ballquery.VARIANTS[v]}")
        require((v, False) not in spilled, f"the ball query variant "
                f"{ballquery.VARIANTS[v]} on a path spills registers")

    t0 = time.perf_counter()
    (fps_sites, bq_sites, pack_sites, gather_sites, probe_sites,
     variant_sites) = check_kernels(torch, np, sm_clock_mhz)
    print(f"kernel checks: {time.perf_counter() - t0:.1f} s", flush=True)

    # each path starts from launch counts of 0 and is read just after
    partial = args.kernels_only or args.skip
    paths = {}
    serve = train = evaluation = probes = cli = mvn = bench = None
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
        if "eval" not in args.skip:
            t0 = time.perf_counter()
            evaluation = eval_flagship(torch, np)
            paths["eval"] = evaluation["launches"]
            print_eval(evaluation)
            print(f"eval phase: {time.perf_counter() - t0:.1f} s", flush=True)
        if "probes" not in args.skip:
            t0 = time.perf_counter()
            probes = run_probes(torch)
            paths["probes"] = probes["launches"]
            print(f"probe phase: {time.perf_counter() - t0:.1f} s", flush=True)
        if "cli" not in args.skip:
            t0 = time.perf_counter()
            cli = cli_phase(torch, np, card)
            paths["cli"] = cli["launches"]
            print(f"  cli: {cli['train_ms_per_step']:.1f} ms per step at "
                  f"B={cli['batch']} ({cli['scenes_per_s']:.1f} scenes/s), "
                  f"fetch {cli['fetch_s_median']:.4f} s per batch, "
                  f"__getitem__ {cli['getitem_ms_native']:.1f} ms native, "
                  f"{cli['getitem_ms_numpy']:.1f} ms numpy, eval "
                  f"{cli['eval_caption_ms_per_batch']:.1f} ms per batch, "
                  f"predict {cli['predict_ms_per_batch']:.1f} ms per batch, "
                  f"saves {cli['checkpoint_save_ms']} ms, profile of a step "
                  f"{cli['profile']}", flush=True)
            print(f"cli phase: {time.perf_counter() - t0:.1f} s", flush=True)
        if "mvn" not in args.skip:
            t0 = time.perf_counter()
            reset_launch_counts()
            mvn = mvn_phase(torch, np, card)
            paths["mvn"] = mvn["launches"]
            print(f"mvn phase: {time.perf_counter() - t0:.1f} s", flush=True)
        if "benchmark" not in args.skip:
            t0 = time.perf_counter()
            reset_launch_counts()
            bench = benchmark_phase(torch, np)
            bench["launches"] = launch_counts()
            print(f"  benchmark: stages {bench['stage_s']} s, backend "
                  f"{bench['meteor_backend']}, card vs CPU "
                  f"{bench['max_abs_diff_vs_cpu']}", flush=True)
            print(f"benchmark phase: {time.perf_counter() - t0:.1f} s",
                  flush=True)

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
        # the tiers above the main path's shapes, counted apart (their
        # launches are also in fps's and ball_query's)
        *(kernel_entry(name, "scan2cap_torch/csrc/fps.cu",
                       "scan2cap_tpu/ops/pallas/fps.py:117",
                       variant_sites[name], launches(name))
          for name in ("fps_cluster16", "fps_shared_state", "fps_streamed")),
        kernel_entry("ball_query_ordered", bq,
                     "scan2cap_tpu/ops/pallas/ballquery.py:58",
                     variant_sites["ball_query_ordered"],
                     launches("ball_query_ordered")),
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
    if evaluation is not None:
        print(json.dumps({"eval": evaluation, "card": card}))
    if cli is not None:
        print(json.dumps({"cli": cli, "card": card}))
    if mvn is not None:
        print(json.dumps({"mvn": mvn, "card": card}))
    if bench is not None:
        print(json.dumps({"benchmark": bench, "card": card}))
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
