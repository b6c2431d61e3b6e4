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
     tokens >= 99% equal; where FPS or the first-k part at a near tie, the
     CPU's forward again from the card's picks with each part proven,
     ``scan2cap_torch.probes.ties``);
  5. train the same model through ``make_train_step`` on a repeated batch:
     launch counts per step, ms per step (median of three timed spans),
     stage times, and step 1's loss and per-tensor gradient norms against
     the port on the CPU (loss 1e-3, norms 1e-2 relative); the loss must be
     finite and fall;
  6. evaluate as scripts/eval.py --eval_caption --eval_detection does:
     the flagship (conditioned as in 5) over two synthetic batches
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
     fixture of 8 at B=16 with --use_normal for one epoch: the same
     launches per step, last.pt and its reference-layout export reloaded
     bit-equal, ms per iteration, fetch s, save ms, __getitem__ ms;
 10. the offline scorer on tests/fixtures/benchmark_mini with NMS and the
     rotated assignment on the card: equal to the CPU's results within
     1e-6 and to the pinned values, seconds per stage;
 11. the pretrained track (``launch/extract_and_train_pretrained.sh``):
     the caption-only CapNet in gt mode at full width (128 GT boxes, 2
     graph steps, 10 locals, top-down with relation and orientation, 3,433
     words, B=32) on a repeated batch, step 1 against the CPU (loss 1e-3,
     gradient norms 1e-2), the loss falls, its greedy decode of every box
     against the CPU's (tokens >= 99% equal); votenet mode's eval (256
     proposals) and its IoU-gated candidates against the CPU's; then the
     entry points as subprocesses on the CLI fixture with a multiview
     store (the port's .npz) beside it: train_maskvotenet --use_multiview
     --use_normal (B=16, one epoch), extract_gt_features on train (two
     augmented passes) and val, train_pretrained (gt, the launch script's
     flags, an in-training eval), eval_pretrained, extract_votenet_features
     from a multiview detector's run folder, train_pretrained and
     eval_pretrained in votenet mode; every loss finite and every store key
     present, launches per extraction forward (MaskVoteNet 5 FPS, 5
     first-k of which 1 ordered, 5 gathers; the detector 5, 5, 5), one
     forward of each extractor held launch by launch against the plain
     versions and traced, MaskVoteNet's features equal to the stored ones,
     and the object encoder on the fixture's crops (one by one and two
     scenes of 128 crops in one launch a layer) held the same way;
 12. the flagship's training-quality trajectory
     (``scan2cap_torch.scripts.quality_trajectory``): one train step of its
     model at B=8 (40,000 points, 256 proposals) with every FPS, first-k
     and gather launch held exactly against its plain version on the card
     (5, 5 and 6 a step); the entry point as a subprocess for 60 steps
     with an evaluation every 30 over one held-out batch (every loss
     finite, the loss at step 60 below step 30's, 5, 5 and 6 launches a
     step; the curve printed); at the same time ``demo_synthetic_train``
     for 29
     detection-only steps (the loss and the box loss fall);
 13. multiview features from frames: ScanNet-layout frames for 2 of the
     CLI fixture's scenes (100 poses each inside the room looking at its
     points, PNG colour at 328 x 256, 16-bit PNG depth at 41 x 32 rendered
     from the scene's points with a z-buffer), ``compute_multiview_features``
     on the card (a few frames' features against the port's ENet on the
     CPU, 1e-4 of the largest value), ``project_multiview_features
     --maxpool`` (its store bitwise, key for key, against a second run of
     the script in process), ``project_multiview_labels`` on one scene, and
     two iterations of ``scan2cap_torch.scripts.train --use_multiview``
     reading the store; ENet frames/s and ms per batch of 64, projection ms
     per frame, points covered, store bytes;
 14. the tools around a trained run, on phase 8's resumed run (trained
     here the same way when phase 8 is skipped): ``export_pth`` as a
     subprocess, whole and ``--detection_only``, each file read back
     bit-equal to the checkpoint; ``visualize`` on a val scene on the card
     with every FPS, first-k and gather launch held against its plain
     version, its kept proposals and captions exactly those of its own
     forward's outputs post-processed on the host, that forward within the
     serving gates of a ``--device cpu`` run's (the boxes kept by one run
     only counted; that run replayed from the card's picks where its index
     stages part, each part a proven near tie); then ScanNet's preparation as subprocesses on a raw scene written
     here (a mesh of 150,000 vertices and 300,000 faces, segments, an
     aggregation of 12 objects, an axis alignment, a label map):
     ``scannet_preprocess.batch_export``, ``check_preprocessed_scene``,
     ``export_scannet_axis_aligned_mesh``, ``organize_scanrefer``,
     ``organize_referit3d`` (quoted commas, no pandas) and
     ``scan2cad_to_scannet``;
 15. the bfloat16 backbone: the flagship of phase 5 at B=2 with
     ``compute_dtype`` and then ``storage_dtype`` bfloat16: step 1 with
     every FPS, first-k and gather launch held against its plain version
     and receiving float32 (5, 5, 6), against the port's CPU run (the
     backbone's FPS and first-k indices exact, the share of the vote
     stage's indices that differ reported, the loss within 3e-2 and the
     gradient's norm within 5e-2), ms per step, kernel ms and busy share
     beside phase 5's float32 step; ``demo_synthetic_train --bf16`` for 15
     steps and ``quality_trajectory --bf16_storage`` for 10 as
     subprocesses;
 16. the mesh (``--mesh 1,1`` over NCCL: one rank, size-1 groups, whose
     collectives are elided; run after phase 8, on its fixture):
     ``train --mesh 1,1`` for 15 steps at
     B=8 (the ``mesh:`` line, its first loss within 2e-3 of phase 8's
     same-seed run without ``--mesh``, 5 FPS, 5 first-k and 6 gathers a
     step, no collective in a traced step, ``last.pt`` read back bit-equal
     without ``--mesh``); then at once ``eval --mesh 1,1`` of phase 8's
     resumed run printing phase 8's scores, ``train --mesh 2,1`` refused
     with the device-count message, and in this process one step as the
     rank with every launch held against its plain version and the
     ``--spatial`` shards' kernels (the ball query and gather of 2 and 4
     query slices at the four SA layers' shapes, B=2 and 8) equal to the
     unsharded kernel's rows; ms per step with and without the mesh, the
     NCCL version;
 17. the mesh across cards (with two or more cards present; ``--cards N``
     asks for N and fails with fewer; with one card the ``multicard`` line
     reads ``"ran": false``): ``scan2cap_torch.scripts.dryrun_multicard``
     over the N cards (the flagship at (N/2, 2) and (N, 1) against one
     card, every rank's step held launch by launch on its own card, the
     spatial stage at 80,000 points over N ranks and the dp-spatial stage
     at (2, N/2), the kernels launched on every other card from this
     process after card 0 (with the 16-block and shared-state FPS tiers
     and both probes, whose launches set per-card attributes), ms per step at each mesh shape with NCCL's kernel ms), then
     on phase 8's fixture ``train --mesh N/2,2``, ``--mesh N,1`` and
     ``--mesh N/2,2 --spatial`` (15 steps at B=8: first loss within 2e-3 +
     1e-3 of phase 8's, 5 FPS, 5 first-k and 6 gathers a step on every
     rank), the N/2,2 run resumed at (N, 1), both last.pt read back
     without ``--mesh`` bit for bit, and ``eval --mesh N/2,2`` of phase 8's
     resumed run (its scores, or its captions' tokens at 99% of phase 8's
     eval);
 18. the serving export (run after phase 16, on phase 8's resumed run):
     ``scan2cap_torch.scripts.export_model`` traces the eval forward at B=1
     on the card through the three custom ops of ``ops/library.py``, saves
     it, ``--load --check``; the loaded program's tokens, boxes and scores
     on a val scene equal the eager forward's bitwise, its 5 FPS, 5
     first-k and 6 gather launches each held against its plain version;
     the same artifact moved to the CPU within the serving gates of the
     port's CPU forward; the card's loaded program against the CPU's
     within the serving gates (the CPU's replayed from the card's picks
     where their index stages part, each part a proven near tie); export,
     load and save s, MB, ms per request loaded and eager;
 19. the 2D baselines (``scan2cap_torch.twod.main`` in process): a seeded
     random ResNet101 in torchvision's layout written as a ``.pth``;
     ``--prep`` of 256 renders (320 x 240, 4 boxes each) on the card, the
     first 24 renders' features within 1e-3 of a ``--device cpu`` prep;
     ``snt`` and ``tdbu`` trained at B=64 (hidden 512, GloVe 300) and
     evaluated, the retrieval bank; ResNet ms per image and per crop, ms
     per decoder step;
 20. the JSON lines: kernels, serving, training, eval, cli, mesh,
     multicard, export, mvn, benchmark, pretrained, quality, multiview,
     tools, bf16, twod, and last the device line.
Launch counts are set to 0 just before each of the paths 4-7, 9, 11-15,
17-19 and read just after; the entry points of 8, 9, 11-15, 16 and 17 and
the ranks of 17 count their own (their stats files and reports).
Subprocesses that are independent and whose speed no path reads run at
once (``run_together``).  ``--kernels-only`` stops after phase 3 (a short
first check of a new kernel).  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import re
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

    # the same weights and batch on the CPU (plain versions) as reference;
    # where their index stages part, the CPU's forward again from the
    # card's picks, each part a proven near tie
    with torch.inference_mode():
        with TieProof(torch) as card_calls:
            gpu = model(batch)
        t0 = time.perf_counter()
        cpu_model = CapNet(cfg, num_vocabs=NUM_VOCABS, device="cpu", seed=0)
        with TieProof(torch) as cpu_calls:
            ref = cpu_model(to_device(host, "cpu"))
        cpu_ms = (time.perf_counter() - t0) * 1e3
        replayed, ties = prove_against_card(
            torch, card_calls, cpu_calls,
            lambda: cpu_model(to_device(host, "cpu")))
        if replayed is not None:
            ref = replayed
    print(f"  serving: card against CPU, index entries apart "
          f"{ties['index_entries_apart']}, proven ties "
          f"{ties['proven_ties']}", flush=True)
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
                lang_cap_agreement=agree, parity=report, **ties,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)


# --------------------------------------------------------------------- phase 5
def condition_weights(torch, model):
    """Bring two layers of the seeded random model into a trained model's
    range (``scripts.dryrun_multicard.condition_weights``)."""
    from scan2cap_torch.scripts.dryrun_multicard import condition_weights
    condition_weights(model)


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
                  nb=2, requests=5):
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


def run_python(name, argv, env, logs, what=None):
    """``python argv`` to its end; its output goes to the log file
    ``<name>.log``, and a failure ends the phase with the log's tail
    (``what`` names the command there, default ``name``)."""
    log = os.path.join(logs, name + ".log")
    t0 = time.perf_counter()
    with open(log, "a") as f:
        rc = subprocess.run([sys.executable, *argv], cwd=ROOT, env=env,
                            stdout=f, stderr=subprocess.STDOUT,
                            timeout=600).returncode
    wall = time.perf_counter() - t0
    with open(log) as f:
        text = f.read()
    require(rc == 0, f"{what or name} exited {rc}:\n{text[-3000:]}")
    return text, wall


def run_entry_point(module, args, env, logs):
    """``python -m module args`` (``run_python``, logged as the module's
    last name)."""
    return run_python(module.rsplit(".", 1)[-1], ["-m", module, *args],
                      env, logs, what=f"{module} {' '.join(args)}")


def run_together(*jobs):
    """Independent ``run_python`` jobs (argument tuples) at once, a thread
    each: most of a subprocess's wall is its start (Python, torch, the
    card's context), which they then share.  Their (text, wall) in order;
    every job ends before the first failure is raised.  Each job's own
    times are taken beside the others: use it where no path's speed is
    read from them."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = [pool.submit(run_python, *job) for job in jobs]
    return [f.result() for f in futures]


def entry_job(module, args, env, logs, name=None):
    """A ``run_together`` job of ``python -m module args``, logged as
    ``name`` (default the module's last name)."""
    return (name or module.rsplit(".", 1)[-1], ["-m", module, *args], env,
            logs, f"{module} {' '.join(args)}")


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


def score_lines(text):
    """An eval's score lines ("[CIDEr]  0.1234", "[score_captions] METEOR
    backend: ..."), not the log lines of its libraries ("[rank0]:[W...")."""
    return [l for l in text.splitlines()
            if re.match(r"\[[\w-]+\]\s", l)]


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


def trace_collectives(path, steps):
    """Collectives per step in a ``--profile`` trace: the host's ops that
    issue them (names starting ``c10d::`` or ``nccl:``) with their host ms,
    and the device's NCCL kernels with their ms."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ops = [e for e in events if e.get("cat") == "cpu_op"
           and e["name"].startswith(("c10d::", "nccl:"))]
    nccl = [e for e in events if e.get("cat") == "kernel"
            and "nccl" in e["name"].lower()]
    by_name = {}
    for e in ops:
        by_name[e["name"]] = by_name.get(e["name"], 0) + 1 / steps
    return dict(host_ops=len(ops) / steps,
                host_ops_ms=sum(e["dur"] for e in ops) / 1e3 / steps,
                host_ops_by_name=by_name, nccl_kernels=len(nccl) / steps,
                nccl_kernel_ms=sum(e["dur"] for e in nccl) / 1e3 / steps)


def cli_phase(torch, np, card, dev="cuda", rehearse=False, keep=False):
    """The port's own entry points as subprocesses on ``dev``, on
    ScanNet-layout fixture data at full scale: train one epoch (the
    in-training eval fires at its last step), resume to epoch 2, evaluate
    captions and detection, write benchmark predictions.  ``rehearse``
    shrinks scenes and model for a run on the CPU (``SCAN2CAP_TEST_TINY``,
    1,024 points, 32 proposals); launches are then not counted.  With
    ``keep`` the fixture and the runs stay on disk for the tools phase
    (``kept``: the directory, the data, the outputs, the resumed run and
    its eval's score lines), which removes them."""
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
        # at once, as none reads another's output: eval, predict and the
        # offline flow's GT boxes (launch/benchmark.sh); their timers are
        # taken beside one another
        (text, walls["eval"]), (_, walls["predict"]), \
            (_, walls["build_benchmark_gt"]) = run_together(
                entry_job("scan2cap_torch.scripts.eval",
                          ["--folder", run_b, "--eval_caption",
                           "--eval_detection", "--save_interm", "--device",
                           dev], env, logs),
                entry_job("scan2cap_torch.benchmark.predict",
                          ["--folder", run_b, "--device", dev], env, logs),
                entry_job("scan2cap_torch.scripts.build_benchmark_gt",
                          ["--split", "val", "--data", data], env, logs))
        for tag in ("[BLEU-4]", "[CIDEr]", "[ROUGE]", "[METEOR]",
                    "mAP@0.25", "mAP@0.5"):
            require(tag in text, f"eval printed no {tag}")
        # the mesh phases evaluate this run again under --mesh: the scores
        # and the kept objects' captions
        eval_scores = score_lines(text)
        with open(os.path.join(out, run_b, "interm.json")) as f:
            interm = json.load(f)
        # then the scorer on the predictions and the GT boxes
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
                    "cider"]),
            kept=dict(root=root, data=data, outputs=out, run=run_b,
                      val=val, eval_scores=eval_scores, interm=interm)
            if keep else None)
    except BaseException:
        shutil.rmtree(root, ignore_errors=True)
        raise
    finally:
        if not keep:
            shutil.rmtree(root, ignore_errors=True)


# ------------------------------------------------------------ the mesh phase
# (name, N, M, radius, nsample) of the four SA layers' ball queries, whose
# query axis --spatial splits
SPATIAL_SITES = (("sa1", 40000, 2048, 0.2, 64), ("sa2", 2048, 1024, 0.4, 32),
                 ("sa3", 1024, 512, 0.8, 16), ("sa4", 512, 256, 1.2, 16))


def mesh_held_step(torch, cfg, host, seed, dev, store):
    """This process as the one rank of ``--mesh 1,1`` (NCCL, through a
    FileStore at ``store``): one train step of the CLI's model on
    ``host``, every FPS, first-k and gather launch held against its plain
    version; the step's launches and loss."""
    from scan2cap_torch.data.synthetic import to_device
    from scan2cap_torch.kernels import launch_counts, reset_launch_counts
    from scan2cap_torch.models import CapNet
    from scan2cap_torch.parallel import mesh as pmesh
    from scan2cap_torch.train.step import create_train_state, make_train_step

    with pmesh.joined(pmesh.MeshSpec(1, 1), 0, dev, store) as mesh:
        model = CapNet(cfg, num_vocabs=NUM_VOCABS, device=mesh.device,
                       seed=seed)
        pmesh.shard_model(model)
        state = create_train_state(cfg, model)
        step = make_train_step(cfg, state, **TRAIN_LOSSES)
        batch = pmesh.local_rows(to_device(host, mesh.device))
        reset_launch_counts()
        with HeldAgainstPlain(torch) as held:
            metrics = step(batch, 1e-3, 0.1)
        torch.cuda.synchronize()
        out = dict(launches=launch_counts(), loss=float(metrics["loss"]),
                   held=[[k, shape] for k, shape in held.checked],
                   nccl=".".join(map(str, torch.cuda.nccl.version())),
                   backend=torch.distributed.get_backend())
    return out


def spatial_shards(torch, dev="cuda", batches=(2, 8)):
    """The --spatial shards' kernels in one process, no collective: at each
    SA layer's shape (B=2 and 8), the ball query and the gather of each of
    2 and 4 contiguous query slices (copied out, as the sharded ops hand
    them over) equal the unsharded kernel's rows exactly."""
    from scan2cap_torch.ops import grouping
    g = torch.Generator(device="cpu").manual_seed(3)
    checks = []
    for name, N, M, r, ns in SPATIAL_SITES:
        for B in batches:
            xyz = (torch.rand((B, N, 3), generator=g) * 4).to(dev)
            new_xyz = xyz[:, :M]
            table = torch.randn((B, N, 128), generator=g).to(dev)
            idx = grouping.ball_query(xyz, new_xyz, r, ns)
            rows = grouping.group_points_forward(table, idx)
            for parts in (2, 4):
                per = M // parts
                for s in range(parts):
                    sl = slice(s * per, (s + 1) * per)
                    part = grouping.ball_query(
                        xyz, new_xyz[:, sl].contiguous(), r, ns)
                    require(torch.equal(part, idx[:, sl]),
                            f"{name} B={B}: ball query of query slice "
                            f"{s}/{parts} differs from the whole's rows")
                    got = grouping.group_points_forward(
                        table, idx[:, sl].contiguous())
                    require(torch.equal(got, rows[:, sl]),
                            f"{name} B={B}: gather of query slice "
                            f"{s}/{parts} differs from the whole's rows")
                checks.append([name, B, parts])
    if dev != "cpu":
        torch.cuda.synchronize()
    return checks


def mesh_phase(torch, np, card, kept=None, dev="cuda", rehearse=False):
    """``--mesh 1,1`` on the card, through the entry points (one NCCL rank,
    size-1 groups): train 15 steps at B=8 on the CLI fixture (its first
    loss against the same seed's run without --mesh, 5 FPS, 5 first-k and
    6 gathers a step, a traced step's collectives, last.pt read back by a
    process without --mesh); then at once, their times not read: eval
    --mesh 1,1 printing the scores of eval without it, --mesh 2,1 refused
    for want of a second card, and in this process one step as the rank
    with every launch held against its plain version, and the --spatial
    shards' kernels against the unsharded kernel's rows.  On the CLI
    phase's fixture, its runs and its eval's scores (``kept``; written here
    when that phase was skipped).  ``rehearse`` runs it on the CPU (gloo)
    at the CLI phase's rehearsal sizes; launches are then not counted and
    no step is held."""
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from scan2cap_torch.config import ModelConfig
    from scan2cap_torch.data.synthetic import make_scene_batch, make_vocab
    from scan2cap_torch.models import CapNet
    from scan2cap_torch.parallel import mesh as pmesh
    from scan2cap_torch.scripts.train import model_config_from_info
    from scan2cap_torch.train.checkpoints import CheckpointIO

    logs = os.path.join(ROOT, "chiprun_out", "mesh")
    os.makedirs(logs, exist_ok=True)
    own = kept is None
    if own:
        root = tempfile.mkdtemp(prefix="scan2cap_mesh_")
        data, _, _ = write_scannet_fixture(
            np, root, points=3000 if rehearse else CLI_SCENE_POINTS)
        out = os.path.join(root, "outputs")
    else:
        root, data, out = kept["root"], kept["data"], kept["outputs"]
    try:
        env = dict(os.environ, SCAN2CAP_DATA=data, SCAN2CAP_OUTPUT=out,
                   PYTHONPATH=ROOT)
        env.pop("SCAN2CAP_TEST_TINY", None)
        flags = [*CLI_FLAGS, "--device", dev, "--epoch", "1", "--val_step",
                 "1000", "--verbose", "1"]
        if rehearse:
            env["SCAN2CAP_TEST_TINY"] = "1"
            flags += ["--num_points", "1024", "--num_proposals", "32"]
        steps = CLI_TRAIN_ENTRIES // CLI_BATCH
        walls = {}
        if own:
            _, walls["train"] = run_entry_point(
                "scan2cap_torch.scripts.train", [*flags, "--tag", "smoke_a"],
                env, logs)
        one = next(d for d in os.listdir(out) if d.endswith("_SMOKE_A"))
        text, walls["train_mesh"] = run_python(
            "train_mesh", ["-m", "scan2cap_torch.scripts.train", *flags,
                           "--mesh", "1,1", "--profile",
                           str(CLI_PROFILED_STEPS), "--tag", "smoke_m"],
            env, logs)
        require("mesh: data=1 model=1" in text,
                f"train --mesh 1,1 printed no mesh line:\n{text[-2000:]}")
        run = next(d for d in os.listdir(out) if d.endswith("_SMOKE_M"))

        def read(r, name):
            with open(os.path.join(out, r, name)) as f:
                return json.load(f)

        stats_1, stats_m = (read(r, "train_stats.json") for r in (one, run))
        info = read(run, "info.json")
        require(info["mesh"] == "1,1", f"info.json mesh {info['mesh']}")
        loss_1 = stats_1["epochs"][0]["losses"][0]
        loss_m = stats_m["epochs"][0]["losses"][0]
        require(abs(loss_m - loss_1) <= 2e-3 * abs(loss_1),
                f"first-step loss {loss_m} under --mesh 1,1, {loss_1} "
                f"without")
        losses = stats_m["epochs"][0]["losses"]
        require(len(losses) == steps and all(np.isfinite(losses)),
                f"--mesh 1,1 losses {losses}")
        per_step = per_call(stats_m["launches"], stats_m["steps"])
        want = dict(furthest_point_sample_cuda=5, ball_query_cuda=5,
                    group_points_cuda=6)
        for k, v in want.items():
            require(rehearse or per_step.get(k) == v, f"--mesh 1,1 step: "
                    f"{k} {per_step.get(k)} launches, the structure's is {v}")
        trace = os.path.join(out, run, "profile", "trace.json")
        profile = dict(trace_kernels(trace, CLI_PROFILED_STEPS),
                       **trace_collectives(trace, CLI_PROFILED_STEPS))
        # every group of --mesh 1,1 holds one rank: nothing is issued
        require(profile["host_ops"] == 0 and profile["nccl_kernels"] == 0,
                f"--mesh 1,1 issued collectives: {profile}")

        # at once: the evals, the refusal, and this process's work
        evaluated = run if own else kept["run"]
        eval_args = ["--folder", evaluated, "--eval_caption", "--device",
                     dev]
        jobs = [entry_job("scan2cap_torch.scripts.eval",
                          [*eval_args, "--mesh", "1,1"], env, logs,
                          "eval_mesh")]
        if own:
            jobs.append(entry_job("scan2cap_torch.scripts.eval", eval_args,
                                  env, logs, "eval_one"))
        # a mesh larger than the devices present (here: a second card)
        n = pmesh.device_count(dev) + 1
        refused = {}

        def refuse():
            refused["res"] = subprocess.run(
                [sys.executable, "-m", "scan2cap_torch.scripts.train",
                 *flags, "--mesh", f"{n},1", "--tag", "smoke_2"], cwd=ROOT,
                env=env, capture_output=True, text=True, timeout=300)

        with ThreadPoolExecutor(2) as pool:
            evals = pool.submit(run_together, *jobs)
            refusal = pool.submit(refuse)

            # last.pt in a process without --mesh
            last = CheckpointIO(os.path.join(out, run, "ckpt")).restore(
                "last")["model"]
            if rehearse:
                os.environ["SCAN2CAP_TEST_TINY"] = "1"
            model = CapNet(model_config_from_info(info),
                           num_vocabs=NUM_VOCABS,
                           num_vocabs_padded=info["num_vocabs_padded"],
                           device=dev, seed=1)
            os.environ.pop("SCAN2CAP_TEST_TINY", None)
            model.load_state_dict(last, strict=True)
            require(all(torch.equal(v.cpu(), last[k])
                        for k, v in model.state_dict().items()),
                    "the --mesh 1,1 last.pt does not load bit-equal")
            del model

            # one step as the rank, every launch held against its plain
            # version
            held = dict(launches={}, held=[], loss=float("nan"), nccl=None,
                        backend=None)
            t0 = time.perf_counter()
            if not rehearse:
                cfg = ModelConfig(num_points=40000, use_normal=True,
                                  use_topdown=True, num_locals=10,
                                  num_graph_steps=2, use_relation=True,
                                  use_orientation=True)
                host = make_scene_batch(
                    cfg, batch_size=CLI_BATCH, num_objects=8,
                    vocab=make_vocab(num_vocabs=NUM_VOCABS,
                                     emb_size=cfg.emb_size), seed=0)
                held = mesh_held_step(torch, cfg, host, 42, dev,
                                      os.path.join(root, "held_store"))
                release_card(torch)
            walls["held_step"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            shards = spatial_shards(torch, dev, batches=(2,) if rehearse
                                    else (2, 8))
            shards_s = time.perf_counter() - t0
            evals, refusal = evals.result(), refusal.result()

        counts = held["launches"]
        for k, v in want.items():
            require(rehearse or counts.get(k) == v and sum(
                1 for kk, _ in held["held"] if kk == k) == v,
                f"held --mesh 1,1 step: {k} {counts.get(k)} launches, "
                f"{held['held']} held; the structure's is {v}")
        require(rehearse or held["backend"] == "nccl"
                and np.isfinite(held["loss"]),
                f"held step: backend {held['backend']}, loss {held['loss']}")
        res = refused["res"]
        msg = (f"--mesh {n},1 needs {n} devices; only {n - 1} available "
               f"({torch.device(dev).type})")
        require(res.returncode != 0 and msg in res.stderr + res.stdout,
                f"train --mesh {n},1 exited {res.returncode}:\n"
                f"{(res.stderr + res.stdout)[-2000:]}")

        scores = dict(mesh=score_lines(evals[0][0]),
                      one=(score_lines(evals[1][0]) if own
                           else kept["eval_scores"]))
        walls["evals"] = [w for _, w in evals]
        require(scores["one"] and scores["one"] == scores["mesh"],
                f"eval scores differ under --mesh 1,1: {scores}")
        ev = read(evaluated, "eval_stats.json")["caption"]

        def median_ms(st):
            s = sorted(st["epochs"][0]["step_s"][2:])
            return s[len(s) // 2] * 1e3

        profile["busy_share_of_step"] = (profile["kernel_ms"]
                                         / median_ms(stats_m))
        launches = sum_launches(stats_m["launches"], ev["launches"])
        return dict(
            card=card, config=" ".join(flags), batch=CLI_BATCH, steps=steps,
            nccl=held["nccl"], backend=held["backend"],
            loss_first=loss_m, loss_first_without=loss_1,
            loss_first_rel_diff=abs(loss_m - loss_1) / abs(loss_1),
            ms_per_step=median_ms(stats_m),
            ms_per_step_without=median_ms(stats_1),
            launches_per_step=per_step, launches=launches, profile=profile,
            held_step=dict(launches=counts, exact=len(held["held"]),
                           loss=held["loss"]),
            eval_scores=scores["mesh"], evaluated=evaluated,
            spatial_shard_checks=shards, spatial_shards_s=shards_s,
            entry_point_wall_s=walls)
    finally:
        if own:
            shutil.rmtree(root, ignore_errors=True)


def print_mesh(r):
    print(f"  mesh 1,1 ({r['backend']}, NCCL {r['nccl']}): "
          f"{r['ms_per_step']:.1f} ms per step, "
          f"{r['ms_per_step_without']:.1f} without; first loss "
          f"{r['loss_first']:.6f} vs {r['loss_first_without']:.6f} "
          f"(rel diff {r['loss_first_rel_diff']:.2e}); launches a step "
          f"{r['launches_per_step']}; trace of a step: "
          f"{r['profile']['kernel_ms']:.2f} ms of kernels, "
          f"{r['profile']['host_ops']:.0f} collectives "
          f"({r['profile']['host_ops_ms']:.2f} ms on the host, "
          f"{r['profile']['nccl_kernel_ms']:.2f} ms of NCCL kernels); "
          f"held step {r['held_step']['exact']} "
          f"launches exact; {len(r['spatial_shard_checks'])} spatial shard "
          f"checks in {r['spatial_shards_s']:.1f} s", flush=True)


# ------------------------------------------------------- the multicard phase
def interm_tokens(interm):
    """Caption tokens by (scene, object) from an ``eval --save_interm``
    dump."""
    return {(scene, obj): entry["token"] for scene, objs in interm.items()
            for obj, entry in objs.items()}


def token_agreement(got, want):
    """Tokens of the kept objects that agree, position by position (an
    object kept by one run only counts all its tokens as differing); the
    share that agrees and the objects that differ."""
    total = same = 0
    differ = []
    for key in sorted(set(got) | set(want)):
        a, b = got.get(key, []), want.get(key, [])
        n = max(len(a), len(b))
        k = sum(1 for x, y in zip(a, b) if x == y)
        total, same = total + n, same + k
        if k != n:
            differ.append(dict(scene=key[0], object=key[1],
                               got=" ".join(a), want=" ".join(b)))
    return (same / total if total else 1.0), differ


def multicard_phase(torch, np, card, n, kept=None, dev="cuda",
                    rehearse=False):
    """The mesh across ``n`` cards, a rank a card over NCCL.  First the
    dryrun (``scan2cap_torch.scripts.dryrun_multicard``, in this process):
    the flagship at (n/2, 2) and (n, 1) against one card, every rank's
    step held launch by launch against the plain versions on its own
    card, the spatial and dp-spatial stages, the kernels launched on every
    other card from this process, the step's ms at each mesh shape with
    NCCL's kernel ms.  Then the entry points as subprocesses on the CLI
    fixture, at once: train --mesh n/2,2, --mesh n,1 and --mesh n/2,2
    --spatial, 15 steps at B=8 (each first loss within 2e-3 + 1e-3 of the
    run without --mesh, 5 FPS, 5 first-k and 6 gathers a step on every
    rank), the n/2,2 run resumed at (n, 1) for epoch 2, and eval --mesh
    n/2,2 --save_interm of the CLI phase's resumed run (its scores, or
    where they differ its caption tokens held to 99% of that phase's eval
    with each differing caption listed); the saved and the resumed
    last.pt read back without --mesh bit for bit.  On the CLI phase's
    fixture and runs (``kept``; written here when that phase was
    skipped).  ``rehearse`` runs it on the CPU (gloo) at the CLI phase's
    rehearsal sizes; launches are then not counted."""
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from scan2cap_torch.models import CapNet
    from scan2cap_torch.scripts import dryrun_multicard
    from scan2cap_torch.scripts.train import model_config_from_info
    from scan2cap_torch.train.checkpoints import CheckpointIO

    release_card(torch)
    t0 = time.perf_counter()
    dry = dryrun_multicard.run(n, dev)
    dry.pop("outputs")
    dry["wall_s"] = time.perf_counter() - t0
    for line in dryrun_multicard.summary(dry):
        print(f"  {line}", flush=True)
    require(not dry["failed"], f"dryrun over {n} cards: {dry['failed']}")
    require(rehearse or all(
        r["held"] == dict(furthest_point_sample_cuda=1, ball_query_cuda=1,
                          group_points_cuda=1)
        and r["attributes"] == dict(fps_cluster16=1, fps_shared_state=1,
                                    pack_probe=1, shift_probe=1)
        for r in dry["other_cards"]),
        f"kernels on the other cards: {dry.get('other_cards')}")

    logs = os.path.join(ROOT, "chiprun_out", "multicard")
    os.makedirs(logs, exist_ok=True)
    own = kept is None
    if own:
        root = tempfile.mkdtemp(prefix="scan2cap_multicard_")
        data, _, _ = write_scannet_fixture(
            np, root, points=3000 if rehearse else CLI_SCENE_POINTS)
        out = os.path.join(root, "outputs")
    else:
        root, data, out = kept["root"], kept["data"], kept["outputs"]
    try:
        env = dict(os.environ, SCAN2CAP_DATA=data, SCAN2CAP_OUTPUT=out,
                   PYTHONPATH=ROOT)
        env.pop("SCAN2CAP_TEST_TINY", None)
        flags = [*CLI_FLAGS, "--device", dev, "--epoch", "1", "--val_step",
                 "1000", "--verbose", "1"]
        if rehearse:
            env["SCAN2CAP_TEST_TINY"] = "1"
            flags += ["--num_points", "1024", "--num_proposals", "32"]
        steps = CLI_TRAIN_ENTRIES // CLI_BATCH
        tp, dp = f"{n // 2},2", f"{n},1"
        train = "scan2cap_torch.scripts.train"
        eval_args = ["--eval_caption", "--save_interm", "--device", dev]
        walls = {}
        if own:
            # the run without --mesh, and its eval, which the mesh's are
            # held to
            _, walls["train"] = run_entry_point(
                train, [*flags, "--tag", "smoke_a"], env, logs)
            evaluated = next(d for d in os.listdir(out)
                             if d.endswith("_SMOKE_A"))
            text, walls["eval"] = run_python(
                "eval_one", ["-m", "scan2cap_torch.scripts.eval",
                             "--folder", evaluated, *eval_args], env, logs)
            one_scores = score_lines(text)
            with open(os.path.join(out, evaluated, "interm.json")) as f:
                one_interm = json.load(f)
        else:
            evaluated = kept["run"]
            one_scores, one_interm = kept["eval_scores"], kept["interm"]
        one = next(d for d in os.listdir(out) if d.endswith("_SMOKE_A"))

        def run_dir(tag):
            return next(d for d in os.listdir(out)
                        if d.endswith("_" + tag.upper()))

        def tp_then_resume():
            first = run_python("train_tp", ["-m", train, *flags, "--mesh",
                                            tp, "--tag", "smoke_tp"],
                               env, logs)
            second = run_python(
                "resume_dp", ["-m", train, *flags, "--epoch", "2", "--mesh",
                              dp, "--use_checkpoint", run_dir("smoke_tp"),
                              "--tag", "smoke_dpr"], env, logs)
            return first, second

        # at once: the walls are not read as a path's speed
        with ThreadPoolExecutor(4) as pool:
            chain = pool.submit(tp_then_resume)
            alone = [pool.submit(run_python, *job) for job in (
                ("train_dp", ["-m", train, *flags, "--mesh", dp, "--tag",
                              "smoke_dp"], env, logs),
                ("train_spatial", ["-m", train, *flags, "--mesh", tp,
                                   "--spatial", "--tag", "smoke_sp"],
                 env, logs),
                ("eval_tp", ["-m", "scan2cap_torch.scripts.eval", "--folder",
                             evaluated, *eval_args, "--mesh", tp], env,
                 logs))]
            (tp_run, resumed), results = chain.result(), [f.result()
                                                          for f in alone]
        (dp_run, spatial_run, eval_run) = results
        walls.update(train_tp=tp_run[1], resume_dp=resumed[1],
                     train_dp=dp_run[1], train_spatial=spatial_run[1],
                     eval_tp=eval_run[1])
        require(f"mesh: data={n // 2} model=2" in tp_run[0]
                and f"mesh: data={n} model=1" in dp_run[0]
                and "spatial(SA query axis over model)" in spatial_run[0],
                "a train run printed no mesh line")
        require(f"resumed from {run_dir('smoke_tp')} at epoch 1"
                in resumed[0], "the (n, 1) run did not resume the (n/2, 2) "
                "run at global epoch 2")

        def read(r, name):
            with open(os.path.join(out, r, name)) as f:
                return json.load(f)

        loss_1 = read(one, "train_stats.json")["epochs"][0]["losses"][0]
        want = dict(furthest_point_sample_cuda=5, ball_query_cuda=5,
                    group_points_cuda=6)
        runs = {}
        # every rank's launches: the dryrun's held steps and the runs'
        launches = sum_launches(*(c for f in dry["flagship"]
                                  for c in f["launches_per_rank"]))
        for tag, what in (("smoke_tp", tp), ("smoke_dp", dp),
                          ("smoke_sp", tp + " --spatial"),
                          ("smoke_dpr", dp + " resumed")):
            st = read(run_dir(tag), "train_stats.json")
            losses = st["epochs"][0]["losses"]
            require(len(losses) == steps and all(np.isfinite(losses)),
                    f"--mesh {what} losses {losses}")
            per_rank = [{k: v for k, v in per_call(c, st["steps"]).items()
                         if v} for c in st["launches_by_rank"]]
            launches = sum_launches(launches, *st["launches_by_rank"])
            require(len(per_rank) == n, f"--mesh {what}: launches of "
                    f"{len(per_rank)} ranks")
            row = dict(loss_first=losses[0], losses=losses,
                       launches_per_step_by_rank=per_rank,
                       ms_per_step=sorted(st["epochs"][0]["step_s"][2:])[
                           (steps - 2) // 2] * 1e3)
            if tag != "smoke_dpr":
                row["loss_first_rel_diff"] = abs(losses[0] - loss_1) / abs(
                    loss_1)
                require(abs(losses[0] - loss_1) <= 2e-3 * abs(loss_1) + 1e-3,
                        f"--mesh {what}: first loss {losses[0]}, {loss_1} "
                        f"without --mesh")
            if tag != "smoke_sp":
                for r, counts in enumerate(per_rank):
                    for k, v in want.items():
                        require(rehearse or counts.get(k) == v,
                                f"--mesh {what} rank {r}: {k} "
                                f"{counts.get(k)} launches a step, want {v}")
            runs[tag] = row

        # last.pt of the (n/2, 2) run and of its resume at (n, 1), read
        # back in this process without --mesh
        info = read(run_dir("smoke_tp"), "info.json")
        if rehearse:
            os.environ["SCAN2CAP_TEST_TINY"] = "1"
        model = CapNet(model_config_from_info(info), num_vocabs=NUM_VOCABS,
                       num_vocabs_padded=info["num_vocabs_padded"],
                       device=dev, seed=1)
        os.environ.pop("SCAN2CAP_TEST_TINY", None)
        for tag in ("smoke_tp", "smoke_dpr"):
            ckpt = CheckpointIO(os.path.join(out, run_dir(tag), "ckpt"))
            last = ckpt.restore("last")["model"]
            model.load_state_dict(last, strict=True)
            require(all(torch.equal(v.cpu(), last[k])
                        for k, v in model.state_dict().items()),
                    f"the {tag} last.pt does not load bit-equal")
        resume = CheckpointIO(os.path.join(out, run_dir("smoke_dpr"),
                                           "ckpt")).restore("resume")
        require(resume["epoch"] == 1 and resume["step"] == 2 * steps,
                f"the resumed run's bundle: epoch {resume['epoch']}, step "
                f"{resume['step']}")
        del model
        release_card(torch)

        scores = score_lines(eval_run[0])
        require(f"mesh: data={n // 2} model=2" in eval_run[0] and scores,
                f"eval --mesh {tp} printed no mesh line or scores")
        with open(os.path.join(out, evaluated, "interm.json")) as f:
            agree, differ = token_agreement(interm_tokens(json.load(f)),
                                            interm_tokens(one_interm))
        require(scores == one_scores or agree >= 0.99,
                f"eval --mesh {tp}: scores {scores} against {one_scores}, "
                f"tokens {agree:.4f} equal: {differ[:5]}")
        return dict(
            ran=True, cards=n, card=card, dryrun=dry, config=" ".join(flags),
            batch=CLI_BATCH, steps=steps, loss_first_without=loss_1,
            runs=runs, eval_scores=scores, eval_scores_one_card=one_scores,
            eval_scores_equal=scores == one_scores,
            eval_tokens_equal=agree, eval_captions_differing=differ,
            evaluated=evaluated, launches=launches, entry_point_wall_s=walls)
    finally:
        if own:
            shutil.rmtree(root, ignore_errors=True)


def print_multicard(r):
    runs = r["runs"]
    print(f"  multicard ({r['cards']} cards, NCCL "
          f"{r['dryrun'].get('nccl')}): "
          + "; ".join(f"{tag} first loss {row['loss_first']:.6f}, "
                      f"{row['ms_per_step']:.1f} ms a step"
                      for tag, row in runs.items())
          + f"; eval scores {'equal' if r['eval_scores_equal'] else 'differ'}"
          f", tokens {r['eval_tokens_equal']:.4f} equal; dryrun "
          f"{r['dryrun']['wall_s']:.1f} s", flush=True)


# --------------------------------------------------------------------- phase 9
# launch/train_maskvotenet.sh: B=16, multiview + normal + height and the
# mask channel, 136 columns with xyz
MVN_BATCH = 16
# step 1's card-against-CPU check at full width, at a smaller batch: the
# CPU's step at B=16 takes minutes; the indices at B=16 are held exactly
# against the plain versions on the card instead (HeldAgainstPlain)
MVN_PARITY_BATCH = 4
# the entry point's run on the CLI fixture: --use_normal (no multiview:
# its features come from an HDF5 file through h5py), one epoch
MVN_CLI_EPOCHS = 1


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


def HeldAgainstPlain(torch, record=False):
    """``scan2cap_torch.probes.held.HeldAgainstPlain``: while open, every
    FPS, first-k and gather launch of the path is held exactly against its
    plain version on the same inputs on the card (a mismatch fails the
    phase)."""
    from scan2cap_torch.probes.held import HeldAgainstPlain as Held
    return Held(record=record, error=PhaseError)


def TieProof(torch, replay=None):
    """``scan2cap_torch.probes.ties.TieProof``: records a run's FPS,
    first-k and gather calls, or (``replay``) runs the CPU's run against a
    recording of the card's, proving each part a near tie (a part that is
    not fails the phase)."""
    from scan2cap_torch.probes.ties import TieProof as Proof
    return Proof(replay=replay, error=PhaseError)


def prove_against_card(torch, card_calls, cpu_calls, rerun):
    """The CPU's run against the card's, both recorded by ``TieProof``:
    where their FPS or first-k results part, ``rerun()`` runs the CPU's
    run again replaying the card's calls, each part proven a near tie, so
    that its later stages start from the card's picks.  Without a part
    nothing is run again.  Returns (the rerun's result or None, the index
    entries apart by stage, the proven ties by stage, each with its step
    or query and both values)."""
    apart = card_calls.entries_apart(cpu_calls)
    if not apart:
        return None, dict(index_entries_apart={}, proven_ties={})
    with TieProof(torch, replay=card_calls) as proof:
        out = rerun()
    return out, dict(index_entries_apart=apart, proven_ties=proof.by_stage())


def train_mask_votenet(torch, np, dev="cuda", cfg=None, B=MVN_BATCH,
                       warmup=2, steps=5, windows=3, lr=1e-3,
                       bn_momentum=0.1):
    """MaskVoteNet's train step at the launch script's width on a repeated
    synthetic batch: step 2 with every kernel launch held against its plain
    version on the card, launches per step, ms per step over ``windows``
    spans, a profiled step.  ``dev="cpu"`` rehearses the control flow (no
    kernels, no launch counts, no profile)."""
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

    held_report = None
    if card:
        # step 2: every FPS, first-k and gather launch of a whole step at
        # B=16 (forward and backward) against its plain version on the same
        # inputs on the card, exactly
        with HeldAgainstPlain(torch) as held:
            step(batch, lr, bn_momentum)
        sync()
        by_kernel = held.counts()
        ordered = sum(1 for k, shape in held.checked
                      if k == "ball_query_cuda" and shape[-1] == 512)
        require(by_kernel == dict(furthest_point_sample_cuda=5,
                                  ball_query_cuda=5, group_points_cuda=6)
                and ordered == 1, f"MaskVoteNet step held against the plain "
                f"versions: {by_kernel}, {ordered} at nsample 512")
        held_report = dict(batch=B, exact=len(held.checked),
                           by_kernel=by_kernel,
                           shapes=[[k, shape] for k, shape in held.checked])
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
                  held_against_plain=held_report)
    if card:
        # device busy share: summed kernel time of one profiled step
        profile = profile_step(lambda: step(batch, lr, bn_momentum),
                               "MaskVoteNet training")
        profile["busy_share_of_steady_step"] = profile["kernel_ms"] / ms
        report.update(profile=profile,
                      peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    return report


def mvn_step1_parity(torch, np, dev="cuda", cfg=None,
                     parity_batch=MVN_PARITY_BATCH, lr=1e-3,
                     bn_momentum=0.1):
    """Step 1 of a fresh MaskVoteNet on the card and on the CPU at
    ``parity_batch``: the same weights and batch, the CPU through the
    port's plain versions, at full width (``step1_parity``'s gates)."""
    from scan2cap_torch.data.synthetic import to_device
    from scan2cap_torch.models.mask_votenet import MaskVoteNet
    from scan2cap_torch.train.step import (create_train_state,
                                           make_mask_votenet_step)

    cfg = cfg or mvn_config()
    small = mvn_batch(np, cfg, parity_batch)

    def first_step(device):
        model = MaskVoteNet(cfg, device=device, seed=0)
        step = make_mask_votenet_step(cfg, create_train_state(cfg, model))
        first = {k: float(v) for k, v in
                 step(to_device(small, device), lr, bn_momentum).items()}
        return first, grad_norms(model)

    p_first, p_norms = first_step(dev)
    t0 = time.perf_counter()
    cpu_first, cpu_norms = first_step("cpu")
    cpu_ms = (time.perf_counter() - t0) * 1e3
    loss_rel, worst_name, worst_rel = step1_parity(
        np, p_first, cpu_first, p_norms, cpu_norms, "MaskVoteNet")
    return dict(batch=parity_batch, num_points=cfg.num_points, ms=cpu_ms,
                loss=cpu_first["loss"], miou=cpu_first["miou"],
                loss_rel_err=loss_rel, worst_grad_norm_rel_err=worst_rel,
                worst_grad_norm_tensor=worst_name, tensors=len(cpu_norms))


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
    --use_normal, one epoch: every loss finite, launches per step the
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
    point beside the step-1 parity check on the CPU."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    train = train_mask_votenet(torch, np)
    train["phase_s"] = time.perf_counter() - t0
    # the entry point on the card beside the CPU's step 1 of the parity
    # check (host work), so its timers are taken beside it
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        cli_done = pool.submit(mvn_cli, torch, np, card)
        train["cpu_reference"] = mvn_step1_parity(torch, np)
        cli = cli_done.result()
    cli["phase_s"] = time.perf_counter() - t0
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


# -------------------------------------------------------------------- phase 11
# the pretrained track (launch/extract_and_train_pretrained.sh): the
# caption-only CapNet's flags, its CLI batch, and the card-vs-CPU decode's
# batch in votenet mode (256 boxes a scene)
PRE_FLAGS = ("--use_topdown", "--use_relation", "--num_graph_steps", "2",
             "--num_locals", "10")
PRE_BATCH = 32
PRE_VOTENET_EVAL_BATCH = 8
# the object encoder: the reference's 1,024-point crops, a batch of them
# one by one and two scenes of 128 crops whole
ENCODER_POINTS = 1024
ENCODER_BATCH = 32
ENCODER_SCENES = 2
# launches of one extraction forward, MaskVoteNet's (one first-k through
# the ordered scan, its aggregation) and the multiview detector's alike
# (sa1 gather-lean at 136 and 135 columns); the encoder's sa1 (height and
# mask) gathers xyz and features apart
EXTRACT_FORWARD = dict(furthest_point_sample_cuda=5, ball_query_cuda=5,
                       group_points_cuda=5)
ENCODER_FORWARD = dict(furthest_point_sample_cuda=4, ball_query_cuda=4,
                       group_points_cuda=5)


def pretrained_config(mode, **overrides):
    from scan2cap_torch.config import ModelConfig
    base = dict(num_proposals=128 if mode == "gt" else 256,
                num_graph_steps=2, num_locals=10, use_topdown=True,
                use_relation=True, use_orientation=True)
    base.update(overrides)
    return ModelConfig(**base)


def condition_graph(torch, model):
    """The graph's sum-aggregated messages of a fresh model reach the
    hundreds, where float32 keeps 5 digits: shrink the message layers to a
    trained model's range (as ``condition_weights`` does for CapNet)."""
    with torch.no_grad():
        for layer in (model.graph.gc_0, model.graph.gc_1,
                      model.graph.edge_layer):
            layer.map_edge_1.weight.mul_(0.1)


def train_pretrained_inprocess(torch, np, dev="cuda", sizes=None,
                               B=PRE_BATCH, num_vocabs=NUM_VOCABS, warmup=2,
                               steps=5, windows=3, lr=1e-3):
    """CapNetPretrained in gt mode at the launch script's width (128 GT
    boxes, 2 graph steps, 10 locals, top-down with relation and
    orientation, 3,433 words, B=32) on a repeated synthetic batch: step 1
    against the port on the CPU (loss 1e-3, gradient norms 1e-2), the loss
    falls, ms per step over ``windows`` spans, and the greedy decode of
    every box against the CPU's."""
    from scan2cap_torch.data.synthetic import (make_pretrained_batch,
                                               make_vocab, to_device)
    from scan2cap_torch.models.capnet_pretrained import CapNetPretrained
    from scan2cap_torch.train.step import (PRETRAINED_REPORT_KEYS,
                                           create_train_state, make_eval_step,
                                           make_pretrained_step)

    card = dev != "cpu"
    cfg = pretrained_config("gt", **(sizes or {}))
    vocab = make_vocab(num_vocabs, cfg.emb_size)
    host = make_pretrained_batch(cfg, "gt", B, vocab, seed=0)
    batch = to_device(host, dev)

    def build(device):
        model = CapNetPretrained(cfg, "gt", num_vocabs, device=device, seed=0)
        condition_graph(torch, model)
        state = create_train_state(cfg, model)
        return model, make_pretrained_step(cfg, state, "gt", orientation=True)

    def sync():
        if card:
            torch.cuda.synchronize()

    model, step = build(dev)
    t0 = time.perf_counter()
    first = {k: float(v) for k, v in step(batch, lr, 0.1).items()}
    sync()
    first_ms = (time.perf_counter() - t0) * 1e3
    require(set(first) == set(PRETRAINED_REPORT_KEYS), f"metrics {first}")
    require(all(np.isfinite(v) for v in first.values())
            and first["cap_loss"] > 0 and first["ori_loss"] > 0,
            f"pretrained step 1: {first}")
    cpu_ref = None
    if card:
        norms = grad_norms(model)
        cpu_model, cpu_step = build("cpu")
        t0 = time.perf_counter()
        cpu_first = {k: float(v) for k, v in
                     cpu_step(to_device(host, "cpu"), lr, 0.1).items()}
        cpu_ms = (time.perf_counter() - t0) * 1e3
        loss_rel, worst_name, worst_rel = step1_parity(
            np, first, cpu_first, norms, grad_norms(cpu_model),
            "CapNetPretrained")
        del cpu_model, cpu_step
        cpu_ref = dict(ms=cpu_ms, loss=cpu_first["loss"],
                       loss_rel_err=loss_rel, worst_grad_norm_rel_err=worst_rel,
                       worst_grad_norm_tensor=worst_name)
    for _ in range(warmup - 1):
        step(batch, lr, 0.1)
    sync()
    window_ms, losses = [], []
    for _ in range(windows):
        t0 = time.perf_counter()
        span = [step(batch, lr, 0.1) for _ in range(steps)]
        sync()
        window_ms.append((time.perf_counter() - t0) * 1e3 / steps)
        losses += [float(m["loss"]) for m in span]
    require(all(np.isfinite(losses)) and np.mean(losses[-steps:]) < first["loss"],
            f"the pretrained loss did not fall on a repeated batch: "
            f"{first['loss']} then {losses}")

    # the greedy decode of every box, card against the CPU on the trained
    # weights
    eval_step = make_eval_step(cfg, model, detection_loss=False)
    sync()
    t0 = time.perf_counter()
    tokens = eval_step(batch)["lang_cap"]
    sync()
    eval_ms = (time.perf_counter() - t0) * 1e3
    cpu_model = CapNetPretrained(cfg, "gt", num_vocabs, device="cpu", seed=1)
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               model.state_dict().items()}, strict=True)
    cpu_tokens = make_eval_step(cfg, cpu_model, detection_loss=False)(
        to_device(host, "cpu"))["lang_cap"]
    # a decode over 3,433 words on two devices may flip a near-tied argmax:
    # the serving phase's gate, 99%
    agree = float((tokens.cpu() == cpu_tokens).float().mean())
    if card:
        require(agree >= 0.99, f"pretrained greedy decode: {agree:.4f} of "
                f"the tokens equal card vs CPU")
    ms = sorted(window_ms)[len(window_ms) // 2]
    return dict(batch=B, boxes=cfg.num_proposals, num_vocabs=num_vocabs,
                hidden=cfg.hidden_size, first_step_ms=first_ms,
                window_ms_per_step=window_ms, ms_per_step=ms,
                samples_per_s=B / ms * 1e3, step1=first, loss_by_step=losses,
                cpu_reference=cpu_ref, eval_ms_per_batch=eval_ms,
                decode_tokens=int(np.asarray(cpu_tokens).size),
                decode_tokens_equal_share=agree)


def votenet_eval_inprocess(torch, np, dev="cuda", sizes=None,
                           B=PRE_VOTENET_EVAL_BATCH, num_vocabs=NUM_VOCABS):
    """CapNetPretrained in votenet mode (256 stored proposals) at full
    width: the eval forward and ``feed_pretrained_cap`` on the card and on
    the CPU with the same weights; the IoU gate (bitwise box IoU) keeps the
    same boxes, and the captions agree."""
    from scan2cap_torch.data.synthetic import make_pretrained_batch, make_vocab
    from scan2cap_torch.eval.eval_pretrained import feed_pretrained_cap
    from scan2cap_torch.models.capnet_pretrained import CapNetPretrained
    from scan2cap_torch.train.step import make_eval_step

    cfg = pretrained_config("votenet", **(sizes or {}))
    vocab = make_vocab(num_vocabs, cfg.emb_size)
    host = make_pretrained_batch(cfg, "votenet", B, vocab, seed=1)
    # a few proposals overlap the reference box: copies of the target's box
    # at growing offsets
    target = host["object_id"]
    for b in range(B):
        for j, dx in enumerate((0.05, 0.15, 0.3, 0.6)):
            k = cfg.num_proposals - 1 - j
            host["bbox_corner"][b, k] = host["bbox_corner"][b, target[b]] + dx
            host["bbox_mask"][b, k] = 1
            host["scene_object_ids"][b, k] = target[b]
    scanrefer = [{"scene_id": f"scene{b:04d}_00"} for b in range(B)]
    organized = {s["scene_id"]: {str(o): {"0": {"object_name": "chair"}}
                                 for o in range(cfg.num_proposals)}
                 for s in scanrefer}
    dataset = EvalDataset(vocab, scanrefer)
    found = {}
    for device in (dev, "cpu"):
        model = CapNetPretrained(cfg, "votenet", num_vocabs, device=device,
                                 seed=0)
        condition_graph(torch, model)
        step = make_eval_step(cfg, model, detection_loss=False)
        t0 = time.perf_counter()
        found[device] = feed_pretrained_cap(step, dataset, [host], organized,
                                            mode="votenet", min_iou=0.5,
                                            device=device)
        found[device + "_ms"] = (time.perf_counter() - t0) * 1e3
    got, want = found[dev], found["cpu"]
    require(set(got) == set(want) and 0 < len(got) < B * cfg.num_proposals,
            f"votenet candidates: card {len(got)}, CPU {len(want)}, "
            f"{sorted(set(got) ^ set(want))[:4]}")
    same = sum(got[k] == want[k] for k in want) / len(want)
    if dev != "cpu":
        require(same >= 0.99, f"votenet captions: {same:.4f} equal card vs "
                f"CPU")
    return dict(batch=B, boxes=cfg.num_proposals, candidates=len(got),
                captions_equal_share=same, feed_ms=found[dev + "_ms"],
                cpu_feed_ms=found["cpu_ms"])


def write_multiview_store(np, data, scenes, points, seed=0):
    """The multiview features of the fixture's scenes as the port's store
    (one seeded (P, 128) float32 array a scene); returns (path, bytes)."""
    from scan2cap_torch.data.feature_store import FeatureStoreWriter
    rng = np.random.default_rng(seed)
    path = os.path.join(data, "scannet", "scannet_data",
                        "enet_feats_maxpool.npz")
    with FeatureStoreWriter(path) as db:
        for sid in scenes:
            db[sid] = rng.standard_normal((points, 128), np.float32) * 0.1
    return path, os.path.getsize(path)


def held_forward(torch, fn, want, what):
    """fn() with every kernel launch held against its plain version on the
    card; the launches must be ``want`` (and one first-k through the ordered
    scan when the forward has MaskVoteNet's aggregation)."""
    with HeldAgainstPlain(torch) as held:
        out = fn()
    torch.cuda.synchronize()
    by_kernel = held.counts()
    require(by_kernel == want, f"{what} held against the plain versions: "
            f"{by_kernel}, want {want}")
    return out, dict(exact=len(held.checked), by_kernel=by_kernel,
                     ordered=sum(1 for k, s in held.checked
                                 if k == "ball_query_cuda" and s[-1] > 256),
                     shapes=[[k, s] for k, s in held.checked])


def encoder_on_card(torch, np, data, train_scenes, card, rehearse):
    """The object encoder on fixture crops (``ScannetObjectDataset``): a
    batch of single 1,024-point crops (sa1 samples 2,048 points of each)
    and two whole scenes of 128 crops in one launch a layer; every launch
    held against its plain version, invalid crops zero."""
    from scan2cap_torch.data.dataset import Loader
    from scan2cap_torch.data.dataset_object import ScannetObjectDataset
    from scan2cap_torch.data.synthetic import to_device
    from scan2cap_torch.models.encoder import PointnetEncoder

    dev = "cuda" if card else "cpu"
    with open(os.path.join(data, "ScanRefer_filtered_train.json")) as f:
        entries = json.load(f)
    common = dict(scannet_data_dir=os.path.join(data, "scannet",
                                                "scannet_data"),
                  glove_path=os.path.join(data, "glove.p"),
                  num_points=256 if rehearse else ENCODER_POINTS,
                  use_height=True)
    sa = (512, 256, 128, 64) if rehearse else (2048, 1024, 512, 256)
    single = ScannetObjectDataset(entries, train_scenes, **common)
    whole = ScannetObjectDataset(entries, train_scenes, whole_scene=True,
                                 is_eval=True, **common)
    report = {}
    for name, ds, B in (("per_object", single, ENCODER_BATCH),
                        ("whole_scene", whole, ENCODER_SCENES)):
        loader = Loader(ds, B, shuffle=False, drop_last=True)
        host = next(iter(loader))
        loader.close()
        batch = to_device(host, dev)
        model = PointnetEncoder(input_feature_dim=2,
                                whole_scene=name == "whole_scene",
                                sa_npoints=sa, device=dev, seed=0)

        def forward():
            with torch.inference_mode():
                return model(batch, train=False)

        if card:
            out, held = held_forward(torch, forward, ENCODER_FORWARD,
                                     f"the encoder ({name})")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            forward()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        else:
            out, held, ms = forward(), None, None
        feats = out["enc_features"].cpu().numpy()
        require(np.isfinite(feats).all(), f"encoder ({name}) not finite")
        if name == "whole_scene":
            masks = host["target_masks"]
            require(masks.sum() > 0 and (feats[masks == 0] == 0).all()
                    and (np.abs(feats[masks == 1]).max(-1) > 0).all(),
                    "whole-scene encoder: invalid crops must be zero")
        report[name] = dict(batch=B, crops=int(np.prod(
            host["point_clouds"].shape[:-2])), crop_points=common[
            "num_points"], sa_npoints=list(sa), ms=ms, held=held)
    return report


def extraction_check(torch, card, forward, loader_batch, want, what):
    """One extraction forward in process on a batch of the fixture, each
    launch held against its plain version and the forward's kernel time
    from a trace.  Returns (report, the forward's output)."""
    from scan2cap_torch.data.synthetic import to_device
    batch = to_device(loader_batch, "cuda" if card else "cpu")
    if not card:
        return None, forward(batch)
    out, held = held_forward(torch, lambda: forward(batch), want, what)
    return dict(held=held, profile=profile_step(lambda: forward(batch),
                                                what)), out


def votenet_leg(torch, np, dev, env, data, out, train, val, glove, scannet,
                mv_path, num_points, train_entries, mask_ds, pre_steps,
                report, run, run_both, run_folder, train_stats,
                extract_stats, keys_present):
    """The pretrained phase's votenet leg (``pretrained_cli``'s step 5):
    a multiview detector's run folder, extract_votenet_features,
    train_pretrained and eval_pretrained in votenet mode; its readings go
    into ``report``."""
    from scan2cap_torch.data.dataset import Loader, ScannetReferenceDataset
    from scan2cap_torch.data.dataset_pretrained import (
        PretrainedVoteNetDataset)
    from scan2cap_torch.data.feature_store import open_feature_store
    from scan2cap_torch.data.synthetic import to_device
    from scan2cap_torch.models import CapNet
    from scan2cap_torch.scripts.train import model_config_from_info
    from scan2cap_torch.train.checkpoints import CheckpointIO, model_bundle
    from scan2cap_torch.train.step import make_eval_step

    on_card = dev != "cpu"
    # 5. the votenet leg: a multiview detector's run folder (seeded,
    # its voting head conditioned so that some proposals are objects)
    det_info = dict(num_points=num_points, num_proposals=256,
                    num_locals=-1, num_graph_steps=0, query_mode="center",
                    graph_mode="edge_conv", graph_aggr="add",
                    use_relation=False, use_orientation=False,
                    use_distance=False, use_topdown=False,
                    use_color=False, use_normal=True, use_multiview=True,
                    no_height=False, no_caption=True)
    os.environ.update({k: env[k] for k in ("SCAN2CAP_TEST_TINY",)
                       if k in env})
    det_cfg = model_config_from_info(det_info)
    os.environ.pop("SCAN2CAP_TEST_TINY", None)
    det_run = "smoke_pre_detector"
    detector = CapNet(det_cfg, num_vocabs=NUM_VOCABS, device=dev, seed=0)
    det_ds = ScannetReferenceDataset(
        [next(e for e in train_entries if e["scene_id"] == s)
         for s in train], train, scannet_data_dir=scannet,
        glove_path=glove, num_points=num_points, use_height=True,
        use_normal=True, use_multiview=True, multiview_path=mv_path)
    loader = Loader(det_ds, 8, shuffle=False, drop_last=False)
    det_batch = next(iter(loader))
    loader.close()
    with torch.no_grad():
        # votes and boxes near the seeds, with their class's mean size
        # (a fresh head throws them metres away), so that some stored
        # proposals overlap the described object
        detector.vgen.conv3.weight.mul_(0.02)
        detector.proposal.conv3.weight.mul_(0.02)
        # and it calls every proposal background: move the objectness
        # bias by the median margin, so that about half are objects
        scores = make_eval_step(det_cfg, detector, detection_loss=False)(
            to_device(det_batch, dev))["objectness_scores"]
        detector.proposal.conv3.bias[1] += torch.median(
            scores[..., 0] - scores[..., 1])
    os.makedirs(os.path.join(out, det_run))
    CheckpointIO(os.path.join(out, det_run, "ckpt")).save(
        "last", model_bundle(detector))
    with open(os.path.join(out, det_run, "info.json"), "w") as f:
        json.dump(det_info, f)
    vn = {}
    texts = run_both("extract_votenet_features", {
        f"extract_votenet_{split}": [
            "--folder", det_run, "--split", split, "--batch_size", "8"]
        for split in ("train", "val")})
    for split, text in zip(("train", "val"), texts):
        vn[split] = extract_stats(
            text, 1, EXTRACT_FORWARD,
            f"extract_votenet_features ({split})")
        vn[split]["keys"], vn[split]["bytes"] = keys_present(
            os.path.join(data, f"votenet_ScanRefer_predictions_{split}"
                               f".npz"),
            [f"0|{s}{x}" for s in (train if split == "train" else val)
             for x in ("_object_ids", "_features", "_bbox_corners",
                       "_gt_ids", "_gt_corners")],
            f"the VoteNet {split} store")
    vn_store = os.path.join(data, "votenet_ScanRefer_predictions_train"
                                  ".npz")
    with open_feature_store(vn_store) as db:
        vn["proposals_kept"] = {s: int(db.shape(f"0|{s}_object_ids")[0])
                                for s in train}
    require(sum(vn["proposals_kept"].values()) > 0, "the detector kept "
            "no proposal in any scene")

    # one detector forward in process, held and traced
    vn["forward"], _ = extraction_check(torch, on_card,
                                        make_eval_step(det_cfg, detector),
                                        det_batch, EXTRACT_FORWARD,
                                        "detector extraction")
    vn_ds = PretrainedVoteNetDataset(train_entries, vn_store,
                                     split="train", glove=mask_ds.glove)
    t0 = time.perf_counter()
    for i in range(16):
        vn_ds.__getitem__(i)
    report["votenet_getitem_ms"] = (time.perf_counter() - t0) * 1e3 / 16
    report["extract_votenet"] = vn

    run("train_pretrained", [
        "--mode", "votenet", *PRE_FLAGS, "--batch_size", str(PRE_BATCH),
        "--epoch", "1", "--verbose", "1", "--val_step", str(pre_steps),
        "--tag", "smoke_pre_vn"], "train_pretrained_votenet")
    vn_run = run_folder("smoke_pre_vn")
    stats, losses, step_ms = train_stats(vn_run)
    # the IoU gate found a target in some batch: the captions trained
    require(max(losses) > 0, f"train_pretrained (votenet): no stored "
            f"proposal passed the IoU gate in any batch: {losses}")
    report["train_pretrained_votenet"] = dict(
        steps=stats["steps"], losses=losses, ms_per_step=step_ms)
    text = run("eval_pretrained", ["--folder", vn_run, "--batch_size",
                                   str(PRE_BATCH)],
               "eval_pretrained_votenet")
    report["eval_pretrained_votenet"] = eval_report(text, out, vn_run)


def pretrained_cli(torch, np, dev="cuda", rehearse=False):
    """The pretrained track through the port's entry points as subprocesses
    on the CLI fixture with a multiview store beside it: MaskVoteNet at the
    launch script's flags (--use_multiview --use_normal, B=16, one epoch),
    extract_gt_features on train (2 augmented passes) and val,
    train_pretrained (gt) with the launch script's flags and an in-training
    eval, eval_pretrained; then extract_votenet_features from a multiview
    detector's run folder, train_pretrained and eval_pretrained in votenet
    mode.  Every loss finite and every store key present; launches per
    extraction forward; one forward of each extractor and the encoder
    held against the plain versions in process.  ``rehearse`` shrinks
    scenes and models for the CPU (``SCAN2CAP_TEST_TINY``)."""
    import shutil
    import tempfile

    from scan2cap_torch.data.dataset import Loader, ScannetReferenceDataset
    from scan2cap_torch.data.dataset_maskvotenet import (
        MaskScannetReferenceDataset)
    from scan2cap_torch.data.dataset_pretrained import (
        PretrainedGTDataset, PretrainedVoteNetDataset)
    from scan2cap_torch.data.feature_store import open_feature_store
    from scan2cap_torch.data.synthetic import to_device
    from scan2cap_torch.models import CapNet
    from scan2cap_torch.models.mask_votenet import MaskVoteNet
    from scan2cap_torch.scripts.train import model_config_from_info
    from scan2cap_torch.scripts.train_maskvotenet import (
        model_config_from_args)
    from scan2cap_torch.train.checkpoints import CheckpointIO, model_bundle
    from scan2cap_torch.train.step import make_eval_step

    from concurrent.futures import ThreadPoolExecutor

    on_card = dev != "cpu"
    root = tempfile.mkdtemp(prefix="scan2cap_pre_")
    logs = os.path.join(ROOT, "chiprun_out", "pretrained")
    os.makedirs(logs, exist_ok=True)
    report = {}
    try:
        t0 = time.perf_counter()
        points = 3000 if rehearse else CLI_SCENE_POINTS
        num_points = 2048 if rehearse else 40000
        data, train, val = write_scannet_fixture(np, root, points=points)
        mv_path, mv_bytes = write_multiview_store(np, data, train + val,
                                                  points)
        report["fixture_s"] = time.perf_counter() - t0
        out = os.path.join(root, "outputs")
        env = dict(os.environ, SCAN2CAP_DATA=data, SCAN2CAP_OUTPUT=out,
                   PYTHONPATH=ROOT)
        env.pop("SCAN2CAP_TEST_TINY", None)
        if rehearse:
            env["SCAN2CAP_TEST_TINY"] = "1"
        scannet = os.path.join(data, "scannet", "scannet_data")
        glove = os.path.join(data, "glove.p")

        def run(module, args, tag=None):
            text, wall = run_entry_point(
                f"scan2cap_torch.scripts.{module}",
                [*args, "--device", dev], env, logs)
            report.setdefault("wall_s", {})[tag or module] = wall
            return text

        def run_both(module, runs):
            """``run`` of several argument lists at once, by tag."""
            done = run_together(*(
                entry_job(f"scan2cap_torch.scripts.{module}",
                          [*args, "--device", dev], env, logs, tag)
                for tag, args in runs.items()))
            for tag, (_, wall) in zip(runs, done):
                report.setdefault("wall_s", {})[tag] = wall
            return [text for text, _ in done]

        def run_folder(tag):
            return next(d for d in os.listdir(out)
                        if d.endswith("_" + tag.upper()))

        def train_stats(run_name):
            with open(os.path.join(out, run_name, "train_stats.json")) as f:
                stats = json.load(f)
            losses = [x for e in stats["epochs"] for x in e["losses"]]
            require(len(losses) == stats["steps"] > 0
                    and all(np.isfinite(losses)),
                    f"{run_name} losses: {losses}")
            step_s = sorted(x for e in stats["epochs"]
                            for x in e["step_s"][1:]) or [float("nan")]
            return stats, losses, step_s[len(step_s) // 2] * 1e3

        def extract_stats(text, batches, want, what):
            line = next(l for l in text.splitlines()[::-1]
                        if l.startswith("extract_stats "))
            stats = json.loads(line[len("extract_stats "):])
            require(stats["batches"] == batches, f"{what}: {stats['batches']} "
                    f"batches, want {batches}")
            per = per_call(stats["launches"], stats["batches"])
            if not rehearse:
                for k, v in want.items():
                    require(per.get(k) == v, f"{what}: {k} {per.get(k)} "
                            f"launches per forward, want {v}")
                if what.startswith("extract_gt"):
                    require(per.get("ball_query_ordered") == 1,
                            f"{what}: {per.get('ball_query_ordered')} ordered "
                            f"first-k per forward, want 1")
            warm = sorted(stats["forward_ms"][1:] or stats["forward_ms"])
            stats.update(launches_per_forward=per,
                         forward_ms_per_batch=warm[len(warm) // 2],
                         wall_ms_per_batch=stats["seconds"] * 1e3
                         / stats["batches"],
                         descriptions_per_s=stats["samples"]
                         / stats["seconds"])
            return stats

        def keys_present(path, want_keys, what):
            with open_feature_store(path) as db:
                missing = sorted(set(want_keys) - set(db.keys()))
                require(not missing, f"{what}: keys missing {missing[:4]}")
                return len(db), os.path.getsize(path)

        # multiview reads: the store alone, and a MaskVoteNet item
        with open(os.path.join(data, "ScanRefer_filtered_train.json")) as f:
            train_entries = json.load(f)
        mask_ds = MaskScannetReferenceDataset(
            train_entries, train, scannet_data_dir=scannet, glove_path=glove,
            num_points=num_points, use_height=True, use_normal=True,
            use_multiview=True, multiview_path=mv_path, augment=True)
        with open_feature_store(mv_path) as db:
            buf = np.empty(db.shape(train[0]), np.float32)
            t0 = time.perf_counter()
            for sid in train:
                db.read_into(sid, buf)
            report["multiview_read_ms"] = (
                (time.perf_counter() - t0) * 1e3 / len(train))
        mask_ds.__getitem__(0, np.random.RandomState(0))
        t0 = time.perf_counter()
        for i in range(8):
            mask_ds.__getitem__(i, np.random.RandomState(i))
        report["multiview_getitem_ms"] = (time.perf_counter() - t0) * 1e3 / 8
        report["multiview_store_bytes"] = mv_bytes

        # 1. MaskVoteNet at the launch script's flags
        run("train_maskvotenet", [
            "--batch_size", str(MVN_BATCH), "--use_normal", "--use_multiview",
            "--epoch", "1", "--verbose", "1", "--num_points", str(num_points),
            "--tag", "smoke_pre_mvn"])
        mvn_run = run_folder("smoke_pre_mvn")
        stats, losses, step_ms = train_stats(mvn_run)
        per_step = per_call(stats["launches"], stats["steps"])
        if not rehearse:
            mvn_launches_right(per_step, "MaskVoteNet with multiview")
        report["mask_votenet"] = dict(steps=stats["steps"], losses=losses,
                                      ms_per_step=step_ms,
                                      launches_per_step=per_step,
                                      launches=stats["launches"])

        # 2. GT features: train (2 augmented passes) and val
        pairs = len(mask_ds)
        with open(os.path.join(data, "ScanRefer_filtered_val.json")) as f:
            val_pairs = len({(e["scene_id"], e["object_id"])
                             for e in json.load(f)})
        batches = 2 * -(-pairs // MVN_BATCH)              # two passes
        # train and val at once (separate stores; their walls overlap)
        text, text_val = run_both("extract_gt_features", {
            "extract_gt_train": [
                "--folder", mvn_run, "--split", "train", "--epoch", "2",
                "--batch_size", str(MVN_BATCH)],
            "extract_gt_val": [
                "--folder", mvn_run, "--split", "val", "--batch_size",
                str(MVN_BATCH)]})
        gt_train = extract_stats(text, batches, EXTRACT_FORWARD,
                                 "extract_gt_features (train)")
        gt_val = extract_stats(text_val, -(-val_pairs // MVN_BATCH),
                               EXTRACT_FORWARD, "extract_gt_features (val)")
        gt_store = os.path.join(data, "gt_ScanRefer_features_train.npz")
        suffixes = ("_gt_ids", "_features", "_bbox_corners", "_gt_corners")
        gt_train["keys"], gt_train["bytes"] = keys_present(
            gt_store, [f"{e}|{s}{x}" for e in range(2) for s in train
                       for x in suffixes], "the GT train store")
        gt_val["keys"], gt_val["bytes"] = keys_present(
            os.path.join(data, "gt_ScanRefer_features_val.npz"),
            [f"0|{s}{x}" for s in val for x in suffixes], "the GT val store")
        report["extract_gt"] = dict(train=gt_train, val=gt_val)

        # one MaskVoteNet extraction forward in process: held, traced, and
        # equal to what the entry point stored for its first batch
        with open(os.path.join(out, mvn_run, "info.json")) as f:
            info = json.load(f)
        os.environ.update({k: env[k] for k in ("SCAN2CAP_TEST_TINY",)
                           if k in env})
        mcfg = model_config_from_args(argparse.Namespace(**info))
        os.environ.pop("SCAN2CAP_TEST_TINY", None)
        extract_ds = MaskScannetReferenceDataset(
            train_entries, train, scannet_data_dir=scannet, glove_path=glove,
            num_points=num_points, use_height=True, use_normal=True,
            use_multiview=True, multiview_path=mv_path, augment=True)
        loader = Loader(extract_ds, MVN_BATCH, shuffle=False, seed=42,
                        drop_last=False)
        first_batch = next(iter(loader))
        loader.close()

        mvn = MaskVoteNet(mcfg, device=dev, seed=1)
        mvn.load_state_dict(CheckpointIO(os.path.join(
            out, mvn_run, "ckpt")).restore("last")["model"], strict=True)

        def mvn_forward(batch):
            with torch.inference_mode():
                return mvn(batch, train=False)

        check, mvn_out = extraction_check(torch, on_card, mvn_forward,
                                          first_batch, EXTRACT_FORWARD,
                                          "MaskVoteNet extraction")
        if on_card:
            require(check["held"]["ordered"] == 1, "MaskVoteNet extraction: "
                    "the aggregation's first-k must go through the ordered "
                    "scan")
        # the entry point stored each scene's rows in loader order: the
        # first batch's sample b is row (its scene's count among samples
        # 0..b-1) of its scene
        feats = mvn_out["aggregated_vote_features"][:, 0].cpu().numpy()
        seen = {}
        with open_feature_store(gt_store) as db:
            for b, i in enumerate(first_batch["dataset_idx"]):
                sid = extract_ds.scanrefer[int(i)]["scene_id"]
                row = seen.get(sid, 0)
                seen[sid] = row + 1
                stored = db[f"0|{sid}_features"][row]
                require(np.abs(stored - feats[b]).max()
                        <= 1e-5 * max(np.abs(feats[b]).max(), 1.0),
                        f"the stored feature of {sid} row {row} is not the "
                        f"in-process forward's")
        report["extract_gt"]["forward"] = check

        # __getitem__ of the pretrained datasets over the written stores
        gt_ds = PretrainedGTDataset(train_entries, gt_store, split="train",
                                    glove=mask_ds.glove)
        t0 = time.perf_counter()
        for i in range(16):
            gt_ds.__getitem__(i, np.random.RandomState(i))
        report["gt_getitem_ms"] = (time.perf_counter() - t0) * 1e3 / 16
        require(gt_ds.num_preset_epochs == 2, f"the GT dataset draws from "
                f"{gt_ds.num_preset_epochs} stored passes, want 2")

        # 3. train_pretrained (gt) with an in-training eval, 4. eval: in a
        # thread beside the votenet leg (5), as neither reads the other's
        # output; their timers are taken beside each other
        pre_steps = len(train_entries) // PRE_BATCH

        def gt_leg():
            run("train_pretrained", [
                "--mode", "gt", *PRE_FLAGS, "--batch_size", str(PRE_BATCH),
                "--epoch", "1", "--verbose", "1", "--val_step",
                str(pre_steps), "--tag", "smoke_pre_gt"],
                "train_pretrained_gt")
            gt_run = run_folder("smoke_pre_gt")
            stats, losses, step_ms = train_stats(gt_run)
            with open(os.path.join(out, gt_run, "log.txt")) as f:
                require("[eval @ iter" in f.read(), "train_pretrained (gt): "
                        "the in-training eval did not fire")
            report["train_pretrained_gt"] = dict(steps=stats["steps"],
                                                 losses=losses,
                                                 ms_per_step=step_ms)
            text = run("eval_pretrained", ["--folder", gt_run,
                                           "--batch_size", str(PRE_BATCH)],
                       "eval_pretrained_gt")
            report["eval_pretrained_gt"] = eval_report(text, out, gt_run)

        with ThreadPoolExecutor(1) as pool:
            gt_done = pool.submit(gt_leg)
            votenet_leg(torch, np, dev, env, data, out, train, val, glove,
                        scannet, mv_path, num_points, train_entries,
                        mask_ds, pre_steps, report, run, run_both,
                        run_folder, train_stats, extract_stats, keys_present)
            gt_done.result()
        vn = report["extract_votenet"]

        # the object encoder on the fixture's crops
        report["encoder"] = encoder_on_card(torch, np, data, train, on_card,
                                            rehearse)
        report["launches"] = sum_launches(
            report["mask_votenet"]["launches"],
            *(x["launches"] for x in (gt_train, gt_val, vn["train"],
                                      vn["val"])),
            report["eval_pretrained_gt"]["launches"],
            report["eval_pretrained_votenet"]["launches"])
        report["store_bytes_written"] = (
            mv_bytes + gt_train["bytes"] + gt_val["bytes"]
            + vn["train"]["bytes"] + vn["val"]["bytes"])
        return report
    finally:
        shutil.rmtree(root, ignore_errors=True)


def sum_launches(*counts):
    keys = {k for c in counts for k in c}
    return {k: sum(c.get(k, 0) for c in counts) for k in sorted(keys)}


def eval_report(text, out, run_name):
    """eval_pretrained's printed metrics and its eval_stats.json."""
    metrics = {}
    for tag in ("BLEU-4", "CIDEr", "ROUGE", "METEOR"):
        line = next((l for l in text.splitlines()
                     if l.startswith(f"[{tag}]")), None)
        require(line is not None, f"eval_pretrained printed no [{tag}]")
        metrics[tag] = float(line.split()[-1])
    with open(os.path.join(out, run_name, "eval_stats.json")) as f:
        stats = json.load(f)
    cap = stats["caption"]
    return dict(metrics=metrics, batches=cap["batches"],
                ms_per_batch=cap["s"] * 1e3 / cap["batches"],
                candidates=stats["candidates"], launches=cap["launches"])


def pretrained_phase(torch, np, dev="cuda", rehearse=False):
    """Phase 11: the pretrained track in process at full width (gt mode's
    train step and decode against the CPU, votenet mode's eval and
    candidates against the CPU), then through its entry points."""
    sizes = (dict(hidden_size=64, emb_size=32) if rehearse else None)
    words = 40 if rehearse else NUM_VOCABS
    t0 = time.perf_counter()
    train = train_pretrained_inprocess(torch, np, dev=dev, sizes=sizes,
                                       num_vocabs=words,
                                       B=4 if rehearse else PRE_BATCH)
    votenet = votenet_eval_inprocess(torch, np, dev=dev, sizes=sizes,
                                     num_vocabs=words,
                                     B=2 if rehearse else
                                     PRE_VOTENET_EVAL_BATCH)
    inprocess_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cli = pretrained_cli(torch, np, dev=dev, rehearse=rehearse)
    # the stores are the port's: nothing here read HDF5
    require("h5py" not in sys.modules, "the pretrained phase imported h5py")
    return dict(train=train, votenet_eval=votenet, cli=cli,
                inprocess_s=inprocess_s, cli_s=time.perf_counter() - t0)


def print_pretrained(r):
    """The pretrained phase's readings, one line each."""
    t, v, c = r["train"], r["votenet_eval"], r["cli"]
    spans = [round(x, 2) for x in t["window_ms_per_step"]]
    print(f"  pretrained: {t['ms_per_step']:.2f} ms per step at "
          f"B={t['batch']} (spans {spans}), "
          f"step-1 parity {t['cpu_reference']}, decode "
          f"{t['eval_ms_per_batch']:.1f} ms, tokens equal to the CPU's "
          f"{t['decode_tokens_equal_share']:.5f}; votenet "
          f"{v['candidates']} candidates, captions equal "
          f"{v['captions_equal_share']:.3f}", flush=True)
    for leg in ("extract_gt", "extract_votenet"):
        for split in ("train", "val"):
            x = c[leg][split]
            print(f"  {leg} {split}: {x['batches']} batches, "
                  f"{x['forward_ms_per_batch']:.1f} ms per forward, "
                  f"{x['descriptions_per_s']:.1f} descriptions/s, "
                  f"{x['bytes']} bytes, launches per forward "
                  f"{x['launches_per_forward']}", flush=True)
        fwd = c[leg]["forward"]
        print(f"  {leg} forward held: {fwd['held']['by_kernel']}, kernels "
              f"{fwd['profile']['kernel_ms']:.2f} ms", flush=True)
    print(f"  pretrained cli: mvn {c['mask_votenet']['ms_per_step']:.1f} ms "
          f"per step, train gt {c['train_pretrained_gt']['ms_per_step']:.1f} "
          f"ms, votenet {c['train_pretrained_votenet']['ms_per_step']:.1f} "
          f"ms; eval {c['eval_pretrained_gt']['ms_per_batch']:.1f} and "
          f"{c['eval_pretrained_votenet']['ms_per_batch']:.1f} ms per batch; "
          f"__getitem__ gt {c['gt_getitem_ms']:.2f}, votenet "
          f"{c['votenet_getitem_ms']:.2f}, multiview "
          f"{c['multiview_getitem_ms']:.1f} ms (store read "
          f"{c['multiview_read_ms']:.1f} ms); stores "
          f"{c['store_bytes_written']} bytes; encoder "
          f"{ {k: e['ms'] for k, e in c['encoder'].items()} } ms; wall "
          f"{c['wall_s']}", flush=True)


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


# ------------------------------------------------------------- phases 12, 13
# scan2cap_torch.scripts.quality_trajectory: the flagship's trajectory at
# full width (its own batches, 40,000 points, 256 proposals, B=8), cut to
# 60 steps with an evaluation every 30 over one held-out batch
QUALITY_STEPS = 60
QUALITY_EVAL_EVERY = 30
# the demo cycles over its 4 batches: its last step (28) trains on the
# batch of its first, so the first and last losses it compares are of one
# batch
DEMO_STEPS = 29
# multiview features from frames: 100 poses a scene for 2 of the CLI
# fixture's scenes, colour 328 x 256 PNG, depth 41 x 32 16-bit PNG; ENet at
# the CLI's batch of 64; every 20th frame projected
MV_SCENES = 2
MV_FRAMES = 100
MV_CPU_FRAMES = 4
# the ENet tolerance of tests/test_torch_enet.py: 1e-4 of the largest value
ENET_TOL = 1e-4


def quality_phase(torch, np, card, dev="cuda", rehearse=False):
    """The trajectory's path: one flagship train step at B=8 with every FPS,
    first-k and gather launch held against its plain version on the card
    (5, 5, 6 a step); the trajectory entry point for ``QUALITY_STEPS``
    steps (every loss finite, the loss at the second evaluation below the
    first's); at the same time the demo entry point for ``DEMO_STEPS``
    detection-only steps (the loss and the box loss fall).  ``rehearse``
    runs both entry points at the trajectory's tiny size on the CPU."""
    import shutil
    import tempfile

    from scan2cap_torch.data.synthetic import (make_scene_batch, make_vocab,
                                               to_device)
    from scan2cap_torch.kernels import launch_counts, reset_launch_counts
    from scan2cap_torch.models import CapNet
    from scan2cap_torch.scripts import quality_trajectory as qt
    from scan2cap_torch.train.step import create_train_state, make_train_step

    logs = os.path.join(ROOT, "chiprun_out", "quality")
    os.makedirs(logs, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=ROOT)
    report = dict(card=card)
    if not rehearse:
        # one step of the trajectory's model on its first batch, held
        args = qt.build_parser().parse_args([])
        cfg = qt.make_config(args)
        vocab = make_vocab(num_vocabs=qt.NUM_VOCABS, emb_size=cfg.emb_size)
        host = make_scene_batch(cfg, batch_size=args.batch_size,
                                num_objects=6, vocab=vocab, seed=0)
        model = CapNet(cfg, num_vocabs=qt.NUM_VOCABS, device=dev,
                       seed=args.seed)
        step = make_train_step(cfg, create_train_state(cfg, model),
                               detection=True, caption=True, orientation=True)
        batch = to_device(host, dev)
        reset_launch_counts()
        with HeldAgainstPlain(torch) as held:
            metrics = step(batch, args.lr, 0.1)
        torch.cuda.synchronize()
        per_step = {k: v for k, v in launch_counts().items() if v}
        by_kernel = held.counts()
        want = dict(furthest_point_sample_cuda=5, ball_query_cuda=5,
                    group_points_cuda=6)
        require(by_kernel == want and per_step == want,
                f"the trajectory's train step: held {by_kernel}, launched "
                f"{per_step}, want {want}")
        require(np.isfinite(float(metrics["loss"])), "held step's loss")
        report["held_step"] = dict(batch=args.batch_size, exact=len(
            held.checked), by_kernel=by_kernel, launches=per_step,
            loss=float(metrics["loss"]),
            shapes=[[k, s] for k, s in held.checked])
        del model, step, batch, metrics
    release_card(torch)

    tmp = tempfile.mkdtemp(prefix="scan2cap_quality_")
    try:
        out = os.path.join(tmp, "trajectory.json")
        size = (["--tiny", "--steps", "4", "--eval_every", "2",
                 "--batch_size", "2", "--num_batches", "1", "--num_points",
                 "512"] if rehearse else
                ["--steps", str(QUALITY_STEPS), "--eval_every",
                 str(QUALITY_EVAL_EVERY)])
        demo_size = (["--steps", "3", "--batch_size", "2", "--num_points",
                      "2048", "--num_batches", "1"] if rehearse
                     else ["--steps", str(DEMO_STEPS)])
        # the trajectory and the demo at once: their step times overlap
        (_, wall), (text, demo_wall) = run_together(
            entry_job("scan2cap_torch.scripts.quality_trajectory",
                      [*size, "--eval_batches", "1", "--out", out,
                       "--device", dev], env, logs),
            entry_job("scan2cap_torch.scripts.demo_synthetic_train",
                      [*demo_size, "--device", dev], env, logs))
        with open(out) as f:
            traj = json.load(f)
        curve = traj["curve"]
        losses = [x for x in curve["loss"] if x is not None]
        require(len(losses) == 2 and all(np.isfinite(losses)),
                f"trajectory losses {curve['loss']}")
        require(losses[1] < losses[0], f"the trajectory's loss did not "
                f"fall from step {curve['step'][1]} to {curve['step'][2]}: "
                f"{losses}")
        per = traj["launches_per_step"]
        require(rehearse or per == dict(furthest_point_sample_cuda=5,
                                        ball_query_cuda=5,
                                        group_points_cuda=6),
                f"the trajectory's launches per step {per}")
        report["trajectory"] = dict(
            wall_s=wall, steps=traj["config"]["steps"], curve=curve,
            ms_per_step=traj["ms_per_step"],
            scenes_per_s=traj["step_scenes_per_sec"],
            eval_s_per_record=traj["eval_s_per_record"],
            launches_per_step=per, eval_launches=traj["eval_launches"],
            card=traj["card"])
        steps = traj["config"]["steps"]
        launches = {k: v * steps for k, v in per.items()}
        for k, v in traj["eval_launches"].items():
            launches[k] = launches.get(k, 0) + v

        demo = json.loads(next(l for l in text.splitlines()[::-1]
                               if l.startswith('{"demo"')))["demo"]
        first, last = demo["first"], demo["last"]
        require(last["loss"] < first["loss"]
                and last["box_loss"] < first["box_loss"],
                f"the demo's losses did not fall: {first} -> {last}")
        report["demo"] = dict(wall_s=demo_wall, steps=demo["steps"],
                              logged=demo["logged"], map25=demo["map25"],
                              ar25=demo["ar25"],
                              scenes_per_s=demo["scenes_per_sec"])
        report["launches"] = launches
        return report
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def release_card(torch):
    """Release this process's cached device memory, so that an entry point
    started next as a subprocess finds the card free (the
    plain versions held against the kernels above take tens of GB)."""
    import gc
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def look_at(np, eye, target):
    """The camera-to-world pose of a camera at ``eye`` looking at
    ``target``, z up: camera x right, y down, z forward (ScanNet's)."""
    fwd = target - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    pose = np.eye(4)
    pose[:3, 0], pose[:3, 1], pose[:3, 2] = right, np.cross(fwd, right), fwd
    pose[:3, 3] = eye
    return pose


def write_frames(np, root, scene_id, points, frames, seed=0,
                 color_size=(328, 256)):
    """ScanNet-layout frames of one scene under ``root/scene_id``: ``frames``
    poses inside the room, each looking at one of its points
    (``pose/<i>.txt``), a seeded PNG colour frame of ``color_size``
    (``color/<i>.png``) and a 16-bit PNG depth frame at the projector's 41 x
    32 (``depth/<i>.png``, millimetres) rendered from the scene's own points
    with a z-buffer: each pixel holds its nearest point's depth, so those
    points pass the projection's depth check."""
    from PIL import Image

    from scan2cap_torch.data.projection import (
        DEPTH_MAX, DEPTH_MIN, PROJECTOR_IMAGE_DIMS, SCANNET_INTRINSICS)

    rs = np.random.RandomState(seed)
    base = os.path.join(root, scene_id)
    for d in ("color", "depth", "pose"):
        os.makedirs(os.path.join(base, d))
    xyz = np.asarray(points[:, :3], np.float64)
    lo, hi = xyz.min(0), xyz.max(0)
    coords = np.concatenate([xyz.T, np.ones((1, len(xyz)))])
    w, h = PROJECTOR_IMAGE_DIMS
    K = SCANNET_INTRINSICS
    cw, ch = color_size
    ramp = np.add.outer(np.arange(ch), np.arange(cw))
    for i in range(frames):
        eye = np.array([*rs.uniform(lo[:2] * 0.8, hi[:2] * 0.8),
                        rs.uniform(1.2, 1.8)])
        pose = look_at(np, eye, xyz[rs.randint(len(xyz))])
        cam = np.linalg.inv(pose) @ coords
        z = cam[2]
        with np.errstate(divide="ignore", invalid="ignore"):
            u = np.round(cam[0] * K[0][0] / z + K[0][2])
            v = np.round(cam[1] * K[1][1] / z + K[1][2])
        ok = ((z >= DEPTH_MIN) & (z <= DEPTH_MAX) & (u >= 0) & (u < w)
              & (v >= 0) & (v < h))
        depth = np.full(h * w, np.inf)
        np.minimum.at(depth, (v[ok] * w + u[ok]).astype(np.int64), z[ok])
        depth_mm = np.where(np.isfinite(depth), np.round(depth * 1000), 0)
        name = f"{i:06d}"
        Image.fromarray(depth_mm.reshape(h, w).astype(np.uint16)).save(
            os.path.join(base, "depth", name + ".png"))
        colour = (ramp[..., None] * (i % 7 + 1) + rs.randint(0, 24, (ch, cw, 3))
                  ) % 256
        Image.fromarray(colour.astype(np.uint8)).save(
            os.path.join(base, "color", name + ".png"))
        np.savetxt(os.path.join(base, "pose", name + ".txt"), pose)


def multiview_phase(torch, np, card, dev="cuda", rehearse=False):
    """Multiview features from frames through the port's entry points as
    subprocesses: frames for ``MV_SCENES`` of the CLI fixture's scenes,
    ``compute_multiview_features`` on ``dev`` (a few frames held against
    the port's ENet on the CPU), ``project_multiview_features --maxpool``
    (held bitwise, key for key, against a run of the same script in this
    process), ``project_multiview_labels`` on one scene, and two training
    iterations of ``scripts.train --use_multiview`` that read the store.
    ``rehearse`` shrinks scenes and frames for the CPU."""
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from scan2cap_torch.data.feature_store import open_feature_store
    from scan2cap_torch.data.frames import load_image
    from scan2cap_torch.models.enet import ENetEncoder
    from scan2cap_torch.scripts import project_multiview_features

    t_phase = time.perf_counter()
    release_card(torch)
    root = tempfile.mkdtemp(prefix="scan2cap_mv_")
    logs = os.path.join(ROOT, "chiprun_out", "multiview")
    os.makedirs(logs, exist_ok=True)
    report = dict(card=card)
    try:
        t0 = time.perf_counter()
        points = 3000 if rehearse else CLI_SCENE_POINTS
        frames = 8 if rehearse else MV_FRAMES
        data, train, _ = write_scannet_fixture(np, root, points=points)
        scannet = os.path.join(data, "scannet", "scannet_data")
        frames_root = os.path.join(root, "frames")
        scenes = train[:MV_SCENES]
        for k, sid in enumerate(scenes):
            verts = np.load(os.path.join(scannet, sid + "_aligned_vert.npy"))
            write_frames(np, frames_root, sid, verts, frames, seed=k)
        report["fixture_s"] = time.perf_counter() - t0
        env = dict(os.environ, SCAN2CAP_DATA=data, PYTHONPATH=ROOT,
                   SCAN2CAP_OUTPUT=os.path.join(root, "outputs"))
        env.pop("SCAN2CAP_TEST_TINY", None)
        if rehearse:
            env["SCAN2CAP_TEST_TINY"] = "1"
        walls = {}

        def run(module, args):
            text, walls[module] = run_entry_point(
                f"scan2cap_torch.scripts.{module}", args, env, logs)
            return text

        def stats(text, key):
            line = next(l for l in text.splitlines()[::-1]
                        if l.startswith('{"' + key))
            return json.loads(line)[key]

        feats = os.path.join(root, "feats")
        # a few frames through the port's ENet on the CPU, beside the run on
        # the card
        with ThreadPoolExecutor(1) as pool:
            computed = pool.submit(run, "compute_multiview_features",
                                   ["--frames_root", frames_root,
                                    "--out_root", feats, "--device", dev])
            cpu = ENetEncoder(device="cpu")
            color = os.path.join(frames_root, scenes[0], "color")
            names = sorted(os.listdir(color))[:MV_CPU_FRAMES]
            x = np.stack([load_image(os.path.join(color, f)) for f in names])
            with torch.inference_mode():
                want = cpu(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
            enet = stats(computed.result(), "compute_multiview_features")
        require(enet["frames"] == MV_SCENES * frames,
                f"ENet ran {enet['frames']} frames")
        got = np.stack([np.load(os.path.join(feats, scenes[0],
                                             f[:-4] + ".npy"))
                        for f in names])
        require(got.shape == (len(names), 128, 32, 41),
                f"ENet features of shape {got.shape}")
        enet_err = float(np.abs(got - want).max() / np.abs(want).max())
        require(enet_err <= ENET_TOL, f"ENet on {dev} vs the CPU: "
                f"{enet_err} of the largest value")

        store = os.path.join(scannet, "enet_feats_maxpool.npz")
        proj_args = ["--scannet_data", scannet, "--frames_root", frames_root,
                     "--features_root", feats, "--maxpool"]
        # the script's store, and a second run in this process beside it
        again = os.path.join(root, "again.npz")
        with ThreadPoolExecutor(1) as pool:
            projected = pool.submit(run, "project_multiview_features",
                                    [*proj_args, "--out", store])
            project_multiview_features.main([*proj_args, "--out", again])
            proj = stats(projected.result(), "project_multiview_features")
        with open_feature_store(store) as a, open_feature_store(again) as b:
            keys = sorted(a.keys())
            require(keys == sorted(b.keys()) and all(
                a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
                and a[k].tobytes() == b[k].tobytes() for k in keys),
                "the projection's store differs from a second run")
            covered = {k: int((np.abs(a[k]).max(-1) > 0).sum()) for k in keys}
        require(keys == sorted(scenes) and all(
            covered[s] > 0 for s in scenes), f"store keys {keys}, points "
            f"with a feature {covered}")

        labels = os.path.join(root, "labels", scenes[0])
        os.makedirs(labels)
        rs = np.random.RandomState(7)
        for f in sorted(os.listdir(os.path.join(frames_root, scenes[0],
                                                "pose"))):
            np.save(os.path.join(labels, f[:-4] + ".npy"),
                    rs.randint(0, 41, (32, 41)))
        ply = os.path.join(root, "labels.ply")
        # the labels' projection and the loop closed (the flagship's flags
        # with multiview read the store; --debug takes one batch of the
        # first scene's entry, so two epochs are two iterations) at once:
        # neither reads the other, nor is timed
        pkg = "scan2cap_torch.scripts."
        (text, walls["project_multiview_labels"]), (_, walls["train"]) = \
            run_together(
                entry_job(pkg + "project_multiview_labels",
                          ["--scannet_data", scannet, "--frames_root",
                           frames_root, "--labels_root",
                           os.path.join(root, "labels"), "--scene_id",
                           scenes[0], "--out", ply], env, logs),
                entry_job(pkg + "train",
                          [*CLI_FLAGS, "--use_multiview", "--num_scenes",
                           str(MV_SCENES), "--debug", "--epoch", "2",
                           "--batch_size", str(CLI_BATCH), "--device", dev,
                           *(["--num_points", "1024", "--num_proposals",
                              "32"] if rehearse else []), "--tag", "mv"],
                          env, logs))
        labelled = int(text.rsplit("(", 1)[1].split("/")[0])
        require(os.path.getsize(ply) > 0 and labelled > 0,
                f"labels: {text[-300:]}")
        out = env["SCAN2CAP_OUTPUT"]
        run_name = next(d for d in os.listdir(out) if d.endswith("_MV"))
        with open(os.path.join(out, run_name, "train_stats.json")) as f:
            tstats = json.load(f)
        losses = [x for e in tstats["epochs"] for x in e["losses"]]
        require(tstats["steps"] == 2 and all(np.isfinite(losses)),
                f"multiview training: {tstats['steps']} steps, {losses}")
        report.update(
            scenes=scenes, scene_points=points, frames_per_scene=frames,
            enet=enet, enet_frames_per_s=enet["frames"] / enet["enet_s"],
            enet_ms_per_batch=enet["enet_s"] * 1e3 / enet["batches"],
            # the first batch pays cuDNN's first call
            enet_ms_per_warm_batch=float(np.median(
                enet["enet_s_per_batch"][1:] or [np.nan])) * 1e3,
            enet_cpu_frames=len(names), enet_max_rel_err=enet_err,
            projection=proj, projection_ms_per_frame=proj[
                "projection_ms_per_frame"],
            points_covered=covered, store_bytes=proj["store_bytes"],
            labelled_points=labelled, train_losses=losses,
            launches=tstats["launches"], entry_point_wall_s=walls,
            phase_s=time.perf_counter() - t_phase)
        return report
    finally:
        shutil.rmtree(root, ignore_errors=True)



# -------------------------------------------------------------------- phase 14
# the tools around a trained run, and ScanNet's preparation from raw scans
RAW_SCENE_POINTS = 150000
RAW_SCENE_FACES = 300000
RAW_SEGMENTS = 1500
RAW_OBJECTS = 12
# raw category -> nyu40 id (a few rows of ScanNet's scannetv2-labels.combined)
RAW_LABELS = (("chair", 5), ("table", 7), ("door", 8), ("bookshelf", 10),
              ("sofa", 6), ("cabinet", 3), ("wall", 1), ("floor", 2))


def write_raw_scannet(np, root, seed=0):
    """One raw ScanNet scene as ``scans/`` holds it, made from ``seed``: a
    mesh of ``RAW_SCENE_POINTS`` vertices and ``RAW_SCENE_FACES`` triangles
    (``_vh_clean_2.ply``), its over-segmentation (``RAW_SEGMENTS``
    segments), an aggregation of ``RAW_OBJECTS`` objects of the labels in
    ``RAW_LABELS`` (two of them wall and floor, which the detection
    filter drops), a meta file with a 30-degree axis alignment, and the
    label map.  Returns (scans dir, scene id, label map path, objects
    of a detection class)."""
    from scan2cap_torch.config import SCANNET_NYU40IDS
    from scan2cap_torch.utils.ply import write_ply

    rs = np.random.RandomState(seed)
    sid = "scene0000_00"
    scans = os.path.join(root, "scans")
    os.makedirs(os.path.join(scans, sid))
    base = os.path.join(scans, sid, sid)
    P, per_seg = RAW_SCENE_POINTS, RAW_SCENE_POINTS // RAW_SEGMENTS
    xyz = rs.uniform(0.0, 6.0, (P, 3)).astype(np.float32)
    xyz[:, 2] *= 0.5
    seg = np.arange(P) // per_seg
    groups, detected = [], 0
    for o in range(RAW_OBJECTS):
        segs = list(range(o * 100, o * 100 + 40))
        lo, hi = segs[0] * per_seg, (segs[-1] + 1) * per_seg
        center = rs.uniform(1.0, 5.0, 3) * [1, 1, 0.3]
        xyz[lo:hi] = center + (rs.rand(hi - lo, 3) - 0.5) * rs.uniform(
            0.3, 1.2, 3)
        label, nyu = RAW_LABELS[o % len(RAW_LABELS)]
        detected += int(nyu in SCANNET_NYU40IDS)
        groups.append({"objectId": o, "label": label, "segments": segs})
    rgb = rs.randint(0, 256, (P, 3)).astype(np.uint8)
    faces = rs.randint(0, per_seg, (RAW_SCENE_FACES, 3)) + (
        np.arange(RAW_SCENE_FACES)[:, None] % RAW_SEGMENTS) * per_seg
    write_ply(base + "_vh_clean_2.ply", xyz, rgb, faces)
    with open(base + "_vh_clean_2.0.010000.segs.json", "w") as f:
        json.dump({"segIndices": seg.tolist()}, f)
    with open(base + ".aggregation.json", "w") as f:
        json.dump({"segGroups": groups}, f)
    c, sn = np.cos(np.pi / 6), np.sin(np.pi / 6)
    mat = np.array([[c, -sn, 0, 1.5], [sn, c, 0, -2.0], [0, 0, 1, 0.1],
                    [0, 0, 0, 1]])
    with open(base + ".txt", "w") as f:
        f.write("axisAlignment = " + " ".join(str(v) for v in mat.ravel())
                + "\nnumColorFrames = 1\n")
    tsv = os.path.join(root, "scannetv2-labels.combined.tsv")
    with open(tsv, "w") as f:
        f.write("raw_category\tnyu40id\n")
        f.writelines(f"{name}\t{nyu}\n" for name, nyu in RAW_LABELS)
    return scans, sid, tsv, detected


def preparation_tools(np, root, env, logs, rehearse=False):
    """The dataset-preparation entry points as subprocesses on a raw
    scene and small annotation files: ``scannet_preprocess.batch_export``,
    ``check_preprocessed_scene``, ``export_scannet_axis_aligned_mesh``,
    ``organize_scanrefer``, ``organize_referit3d`` (a CSV with quoted
    commas and token lists) and ``scan2cad_to_scannet``."""
    from scan2cap_torch.utils.ply import read_ply

    t0 = time.perf_counter()
    scans, sid, tsv, detected = write_raw_scannet(np, root)
    walls = dict(write_raw_scene=time.perf_counter() - t0)
    prep = os.path.join(root, "scannet_data")
    _, walls["batch_export"] = run_python("batch_export", [
        "-c", "import sys; from scan2cap_torch.data.scannet_preprocess "
        "import batch_export; print(batch_export(*sys.argv[1:4]))",
        scans, prep, tsv], env, logs)
    verts = np.load(os.path.join(prep, sid + "_aligned_vert.npy"))
    raw = np.load(os.path.join(prep, sid + "_vert.npy"))
    bboxes = np.load(os.path.join(prep, sid + "_aligned_bbox.npy"))
    ins = np.load(os.path.join(prep, sid + "_ins_label.npy"))
    require(verts.shape == raw.shape == (50000, 9) and len(ins) == 50000,
            f"batch_export: {verts.shape}, {raw.shape}, {ins.shape}")
    require(len(bboxes) == detected, f"{len(bboxes)} boxes, {detected} "
            f"objects of a detection class")
    # area-weighted normals: unit length, zero at a vertex no face uses
    norms = np.linalg.norm(verts[:, 6:9], axis=1)
    unit = np.abs(norms - 1) < 1e-3
    require(np.isfinite(verts).all() and (unit | (norms == 0)).all()
            and unit.mean() > 0.95, "vertex normals are not unit length")
    vis = os.path.join(root, "check")
    aligned = os.path.join(root, "aligned")
    ann = os.path.join(root, "annotations")
    os.makedirs(ann)
    entries = [{"scene_id": sid, "object_id": str(o), "ann_id": str(a),
                "object_name": RAW_LABELS[o % len(RAW_LABELS)][0],
                "token": ["the", "object", str(o)],
                "description": f"the object {o}"}
               for o in range(RAW_OBJECTS) for a in range(2)]
    with open(os.path.join(ann, "ScanRefer_filtered.json"), "w") as f:
        json.dump(entries, f)
    with open(os.path.join(ann, "nr3d.csv"), "w") as f:
        f.write("scan_id,target_id,instance_type,assignmentid,utterance,"
                "tokens\n")
        for o in range(RAW_OBJECTS):
            f.write(f'{sid},{o},"{RAW_LABELS[o % 8][0]}, {o}",A{o},'
                    f'"The {RAW_LABELS[o % 8][0]}, near ""it""",'
                    f'"[\'the\', \'{RAW_LABELS[o % 8][0]}\', \',\']"\n')
    for split, scenes in (("train", [sid]), ("val", [])):
        with open(os.path.join(ann, f"{split}.txt"), "w") as f:
            f.writelines(s + "\n" for s in scenes)
    s = float(np.sqrt(0.5))
    with open(os.path.join(ann, "full_annotations.json"), "w") as f:
        json.dump([{"id_scan": sid, "aligned_models": [
            {"trs": {"rotation": [s, 0.0, 0.0, s]}}
            for _ in range(RAW_OBJECTS)]}], f)
    with open(os.path.join(ann, "aligned_cad2inst_id.json"), "w") as f:
        json.dump({sid: {str(o): o for o in range(RAW_OBJECTS)}}, f)
    rot_path = os.path.join(ann, "scannet_instance_rotations.json")
    # the five read what is written above and nothing of each other: at
    # once (each wall is mostly its start)
    pkg = "scan2cap_torch.scripts."
    jobs = {
        "check_preprocessed_scene": [
            "--scannet_data", prep, "--scene_id", sid, "--out", vis],
        "export_scannet_axis_aligned_mesh": [
            "--scans", scans, "--scene_id", sid, "--out", aligned],
        "organize_scanrefer": ["--data", ann],
        "organize_referit3d": [
            "--csv", os.path.join(ann, "nr3d.csv"), "--data", ann,
            "--train_scenes", os.path.join(ann, "train.txt"),
            "--val_scenes", os.path.join(ann, "val.txt")],
        "scan2cad_to_scannet": ["--scan2cad", ann, "--out", rot_path]}
    ran = run_together(*(entry_job(pkg + name, args, env, logs)
                         for name, args in jobs.items()))
    for name, (_, wall) in zip(jobs, ran):
        walls[name] = wall
    require(len(read_ply(os.path.join(vis, sid + "_points.ply"))["vertex"])
            == 50000, "check_preprocessed_scene's point PLY")
    mesh = read_ply(os.path.join(aligned, sid + "_aligned.ply"))
    require(len(mesh["vertex"]) == RAW_SCENE_POINTS
            and len(mesh["face"]) == RAW_SCENE_FACES,
            "the aligned mesh lost vertices or faces")
    with open(os.path.join(ann, "ScanRefer_filtered_organized.json")) as f:
        require(len(json.load(f)[sid]) == RAW_OBJECTS, "organize_scanrefer")
    with open(os.path.join(ann, "ReferIt3D_filtered_train.json")) as f:
        nr3d = json.load(f)
    require(len(nr3d) == RAW_OBJECTS and nr3d[0]["token"][-1] == ","
            and nr3d[0]["description"] == 'the chair, near "it"',
            f"organize_referit3d: {nr3d[:1]}")
    with open(rot_path) as f:
        rot = np.asarray(json.load(f)[sid]["3"])
    require(np.allclose(rot, [[0, -1, 0], [1, 0, 0], [0, 0, 1]], atol=1e-6),
            f"scan2cad_to_scannet's rotation {rot}")
    return dict(wall_s=walls, scene_points=RAW_SCENE_POINTS,
                scene_faces=RAW_SCENE_FACES, boxes=int(len(bboxes)),
                objects=RAW_OBJECTS)


# what visualize's post-processing reads of its forward
VIS_KEYS = ("bbox_corner", "objectness_scores", "sem_cls_scores", "lang_cap",
            "object_assignment")
# the card's forward against the CPU's (PERF.md section 2's serving gates)
VIS_CORNER_TOL = 1e-3
VIS_AGREE = 0.99


def serving_gates(torch, card, cpu, tokens, what):
    """The card's forward against the CPU's on the same input: corners
    within ``VIS_CORNER_TOL``, objectness and class argmax and the
    ``tokens`` equal on ``VIS_AGREE`` of the proposals (steps).  Returns
    (corners' largest difference, agreement by output)."""
    card = {k: v.detach().cpu() for k, v in card.items()}
    cpu = {k: v.detach().cpu() for k, v in cpu.items()}
    corner_err = float((card["bbox_corner"] - cpu["bbox_corner"]).abs().max())
    agree = {k: float((torch.argmax(card[k], -1) == torch.argmax(cpu[k], -1))
                      .float().mean()) for k in ("objectness_scores",
                                                 "sem_cls_scores")}
    agree["tokens"] = float((card[tokens] == cpu[tokens]).float().mean())
    require(corner_err <= VIS_CORNER_TOL, f"{what}: corners differ by "
            f"{corner_err} between the card and the CPU")
    require(min(agree.values()) >= VIS_AGREE, f"{what}: the card and the "
            f"CPU agree on {agree}")
    return corner_err, agree


def held_visualize(np, forwards, caps, files, cpu_files, data):
    """visualize's card run against its post-processing and the CPU run.

    The card's forward outputs, post-processed on the host by the script's
    own ``kept_proposals`` and decoded there, must give exactly the boxes
    and captions the card run kept and wrote.  The card's forward must be
    the CPU run's within the serving gates: corners 1e-3, objectness and
    class argmax on 99% of proposals, tokens on 99%.  Where the two runs'
    index stages parted, the CPU run is the one replayed from the card's
    picks, each part a proven near tie (``prove_against_card``).  Boxes whose NMS
    decision lies a rounding from its threshold may be kept by one run
    only: their number is reported.  Where both runs keep the same boxes,
    their files and captions must be equal."""
    import torch

    from scan2cap_torch.data.dataset import get_scanrefer
    from scan2cap_torch.data.vocab import build_vocabulary, load_glove
    from scan2cap_torch.eval.eval_helper import decode_caption
    from scan2cap_torch.scripts import visualize

    (card, card_keep), (cpu, cpu_keep) = forwards
    require(np.array_equal(visualize.kept_proposals(card), card_keep),
            "visualize: the card's outputs post-processed on the host keep "
            "other boxes than the card run")
    # the vocabulary the script's dataset builds
    train = get_scanrefer(*(os.path.join(data, f"ScanRefer_filtered_{s}.json")
                            for s in ("train", "val")))[0]
    idx2word = build_vocabulary(train, load_glove(
        os.path.join(data, "glove.p")))["idx2word"]
    tokens = card["lang_cap"].numpy()[0]
    want = {str(int(k)): decode_caption(tokens[k], idx2word)
            for k in np.where(card_keep)[0]}
    require(caps[0] == want, f"visualize: the card run's captions are not "
            f"its forward's: {sorted(caps[0])[:8]} against {sorted(want)[:8]}")
    corner_err, agree = serving_gates(torch, card, cpu, "lang_cap",
                                      "visualize")
    differ = int(np.sum(card_keep != cpu_keep))
    pred = [f for f in files if f.startswith("pred")]
    require(sorted(f for f in files if not f.startswith("pred")) ==
            sorted(f for f in cpu_files if not f.startswith("pred")),
            f"visualize wrote {files} on the card, {cpu_files} on the CPU")
    require(bool(pred) == bool(card_keep.any()) and
            len(pred) <= int(card_keep.sum()) + 1,
            f"visualize: {len(pred)} box files for {int(card_keep.sum())} "
            f"kept boxes")
    if not differ:
        require(files == cpu_files and caps[0] == caps[1],
                f"visualize: the same boxes kept, yet the files or captions "
                f"differ: card {sorted(caps[0])[:8]}, CPU {sorted(caps[1])[:8]}")
    return dict(kept_cpu=int(cpu_keep.sum()), kept_differ=differ,
                corner_max_abs_err=corner_err, agree=agree)


def tools_phase(torch, np, card, dev="cuda", kept=None, rehearse=False):
    """The tools around a trained run and the dataset preparation, on the
    CLI phase's fixture and resumed run (``kept``; else a run trained here
    the same way): ``export_pth`` as a subprocess, whole and
    ``--detection_only``, read back bit-equal to the checkpoint;
    ``visualize`` in process on the card (the run's weights with the
    proposal head conditioned so that boxes pass the objectness gate and
    overlap) with every FPS, first-k and gather launch held against its
    plain version, its kept proposals and captions those of its own
    forward post-processed on the host, and its forward within the
    serving gates of a ``--device cpu`` run of the same checkpoint
    (``held_visualize``); beside them ``preparation_tools``."""
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from scan2cap_torch import convert
    from scan2cap_torch.kernels import launch_counts, reset_launch_counts
    from scan2cap_torch.scripts import visualize
    from scan2cap_torch.train.checkpoints import CheckpointIO

    logs = os.path.join(ROOT, "chiprun_out", "tools")
    os.makedirs(logs, exist_ok=True)
    report = dict(card=card)
    if kept is None:
        root = tempfile.mkdtemp(prefix="scan2cap_tools_")
        data, _, val = write_scannet_fixture(
            np, root, points=3000 if rehearse else CLI_SCENE_POINTS)
        out = os.path.join(root, "outputs")
    else:
        root, data, out, val = (kept[k] for k in ("root", "data", "outputs",
                                                  "val"))
    env = dict(os.environ, SCAN2CAP_DATA=data, SCAN2CAP_OUTPUT=out,
               PYTHONPATH=ROOT)
    env.pop("SCAN2CAP_TEST_TINY", None)
    if rehearse:
        env["SCAN2CAP_TEST_TINY"] = "1"
    saved_env = {k: os.environ.get(k) for k in
                 ("SCAN2CAP_DATA", "SCAN2CAP_OUTPUT", "SCAN2CAP_TEST_TINY")}
    # the preparation tools (their own raw scene, subprocesses on the host)
    # and the export beside visualize, none reading another's files
    pool = ThreadPoolExecutor(2)
    try:
        prep_root = os.path.join(root, "raw")
        os.makedirs(prep_root)
        preparation = pool.submit(preparation_tools, np, prep_root, env,
                                  logs, rehearse)
        if kept is None:
            flags = [*CLI_FLAGS, "--device", dev]
            if rehearse:
                flags += ["--num_points", "1024", "--num_proposals", "32"]
            run_entry_point("scan2cap_torch.scripts.train",
                            [*flags, "--epoch", "1", "--val_step", "1000",
                             "--tag", "tools"], env, logs)
            run = next(d for d in os.listdir(out) if d.endswith("_TOOLS"))
        else:
            run = kept["run"]
        run_dir = os.path.join(out, run)
        sd = CheckpointIO(os.path.join(run_dir, "ckpt")).restore_best_or_last(
            )["model"]

        # export: the whole model and its detection modules at once, beside
        # visualize, each read back after it
        exports = (("full", [], "model.pth", set(sd)),
                   ("detection_only", ["--detection_only"], "votenet.pth",
                    {k for k in sd if k.split(".")[0] in
                     convert.DETECTION_MODULES}))
        exported = pool.submit(run_together, *(entry_job(
            "scan2cap_torch.scripts.export_pth", ["--folder", run, *extra],
            env, logs, name=f"export_pth_{what}")
            for what, extra, _, _ in exports))

        # visualize on the card, held, then on the CPU, on a copy of the
        # run whose proposals pass the objectness gate and overlap (the
        # objectness logit +4, boxes nine times their class's mean size,
        # one class; tests/test_torch_tools.py), so that NMS has work
        vis_run = run + "_VIS"
        os.makedirs(os.path.join(out, vis_run))
        shutil.copy(os.path.join(run_dir, "info.json"),
                    os.path.join(out, vis_run, "info.json"))
        conditioned = {k: v.clone() for k, v in sd.items()}
        bias = conditioned["proposal.conv3.bias"]
        bias[1] += 4.0
        bias[25:79] += 8.0
        bias[79] += 6.0
        CheckpointIO(os.path.join(out, vis_run, "ckpt")).save(
            "best", {"model": conditioned})
        os.environ.update({k: env[k] for k in ("SCAN2CAP_DATA",
                                               "SCAN2CAP_OUTPUT")})
        if rehearse:
            os.environ["SCAN2CAP_TEST_TINY"] = "1"
        argv = ["--folder", vis_run, "--scene_id", val[0]]
        # each run's forward outputs, as the script's kept_proposals sees
        # them, and what it kept
        forwards = []
        kept_proposals = visualize.kept_proposals

        def recording(out):
            keep = kept_proposals(out)
            forwards.append(({k: out[k].detach().cpu() for k in VIS_KEYS},
                             keep))
            return keep

        visualize.kept_proposals = recording
        try:
            reset_launch_counts()
            t0 = time.perf_counter()
            with TieProof(torch) as card_calls:
                if dev == "cuda":
                    with HeldAgainstPlain(torch) as held:
                        vis_dir = visualize.main([*argv, "--device", dev])
                    torch.cuda.synchronize()
                else:
                    held, vis_dir = None, visualize.main([*argv, "--device",
                                                          dev])
            card_s = time.perf_counter() - t0
            launches = {k: v for k, v in launch_counts().items() if v}
            card_dir = vis_dir + "_card"
            shutil.move(vis_dir, card_dir)
            t0 = time.perf_counter()
            with TieProof(torch) as cpu_calls:
                visualize.main([*argv, "--device", "cpu"])
            cpu_s = time.perf_counter() - t0

            def rerun():
                shutil.rmtree(vis_dir)
                return visualize.main([*argv, "--device", "cpu"])

            # where the index stages part, the CPU run again from the
            # card's picks: its forward and files are the CPU's below
            replayed, ties = prove_against_card(torch, card_calls,
                                                cpu_calls, rerun)
        finally:
            visualize.kept_proposals = kept_proposals
        runs = 2 if replayed is None else 3
        require(len(forwards) == runs, f"visualize ran {len(forwards)} "
                f"forwards for {runs} runs")
        forwards = [forwards[0], forwards[-1]]
        files, cpu_files = (sorted(os.listdir(d)) for d in (card_dir,
                                                            vis_dir))
        caps = []
        for d in (card_dir, vis_dir):
            with open(os.path.join(d, "captions.json")) as f:
                caps.append(json.load(f))
        vis = held_visualize(np, forwards, caps, files, cpu_files, data)
        if held is not None:
            by_kernel = held.counts()
            require(by_kernel == launches and
                    launches.get("furthest_point_sample_cuda") == 5
                    and launches.get("ball_query_cuda") == 5,
                    f"visualize: held {by_kernel}, launched {launches}")
        report["visualize"] = dict(
            scene=val[0], card_s=card_s, cpu_s=cpu_s, files=files,
            kept=len(caps[0]), launches=launches,
            held=len(held.checked) if held is not None else 0, **vis,
            **ties)
        report["launches"] = launch_counts()
        walls = {f"export_{what}": wall for (what, _, _, _), (_, wall)
                 in zip(exports, exported.result())}
        for what, extra, name, keys in exports:
            back = convert.state_dict_from_reference(
                os.path.join(run_dir, name))
            require(set(back) == keys and all(torch.equal(back[k], sd[k])
                                              for k in keys),
                    f"export_pth {what}: {name} does not read back "
                    f"bit-equal to the checkpoint")
        report["export"] = dict(wall_s=walls, tensors=len(sd))
        release_card(torch)
        report["preparation"] = preparation.result()
        return report
    finally:
        pool.shutdown()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(root, ignore_errors=True)


# -------------------------------------------------------------------- phase 18
# the serving export of the CLI phase's resumed run: B=1, the requests
# timed for the loaded program and the eager forward each
EXPORT_BATCH = 1
EXPORT_REQUESTS = 10
EXPORT_KEYS = ("tokens", "bbox_corner", "objectness_scores", "sem_cls_scores")
# the forward's index stages, in order: the backbone's samples, the
# aggregation's picks, the graph's neighbours
EXPORT_STAGES = ("sa1_inds", "sa2_inds", "fp2_inds", "aggregated_vote_inds",
                 "edge_nbr_idx", "lang_cap")
OVERHEAD_CALLS = 200


def op_overhead_us(torch):
    """Host us per call of each custom op and of its wrapper alone, on
    inputs too small for the kernel's time to count (64 points, 8 picks,
    8 queries, 4 samples, 4 channels): what the op's dispatch adds.  The
    wrappers' launch counts are put back."""
    from scan2cap_torch.kernels import (ball_query_cuda,
                                        furthest_point_sample_cuda,
                                        group_points_cuda, launch_counts)
    from scan2cap_torch.ops.grouping import radius_squared
    g = torch.Generator().manual_seed(0)
    xyz = torch.rand(1, 64, 3, generator=g).cuda()
    q = xyz[:, :8].contiguous()
    feats = torch.rand(1, 64, 4, generator=g).cuda()
    idx = torch.randint(0, 64, (1, 8, 4), generator=g,
                        dtype=torch.int32).cuda()
    r2 = radius_squared(0.3)
    pairs = dict(
        furthest_point_sample=(
            lambda: torch.ops.scan2cap.furthest_point_sample(xyz, 8),
            lambda: furthest_point_sample_cuda(xyz, 8)),
        ball_query=(lambda: torch.ops.scan2cap.ball_query(xyz, q, 0.3, 4),
                    lambda: ball_query_cuda(xyz, q, r2, 4)),
        group_points=(lambda: torch.ops.scan2cap.group_points(feats, idx),
                      lambda: group_points_cuda(feats, idx)))
    before = launch_counts()
    out = {}
    for name, (op, wrapper) in pairs.items():
        for what, fn in (("op", op), ("wrapper", wrapper)):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(OVERHEAD_CALLS):
                fn()
            torch.cuda.synchronize()
            out[f"{name}_{what}"] = ((time.perf_counter() - t0) * 1e6
                                     / OVERHEAD_CALLS)
    for w in (furthest_point_sample_cuda, ball_query_cuda,
              group_points_cuda):
        w.launches = before[w.__name__]
    ball_query_cuda.ordered_launches = before["ball_query_ordered"]
    return out


def export_phase(torch, np, card, kept=None, dev="cuda", rehearse=False):
    """``scan2cap_torch.scripts.export_model`` on the CLI phase's resumed
    run (``kept``; else one trained here as the tools phase does): the eval
    forward exported at B=1 on ``dev`` and saved, ``--load --check``
    through the entry point; the loaded program on a val scene equal to the
    eager ``Serve`` forward bitwise, its every FPS, first-k and gather
    launch held against its plain version (5, 5 and 6: the CLI
    configuration's forward); the same artifact moved to the CPU against
    the port's CPU forward (the serving gates, and whether bitwise); the
    card's loaded program against the CPU's within the serving gates, the
    CPU's replayed from the card's picks where their index stages part,
    each part a proven near tie (``prove_against_card``), with the index
    entries apart by stage and the proven ties; export, load and save s,
    the artifact's MB, ms per request loaded and eager, the ops' dispatch
    cost per call."""
    import shutil
    import tempfile

    from scan2cap_torch.config import PathConfig
    from scan2cap_torch.data.dataset import ScannetReferenceDataset
    from scan2cap_torch.kernels import launch_counts, reset_launch_counts
    from scan2cap_torch.scripts import export_model
    from scan2cap_torch.scripts.train import dataset_kwargs

    logs = os.path.join(ROOT, "chiprun_out", "export")
    os.makedirs(logs, exist_ok=True)
    own = kept is None
    if own:
        root = tempfile.mkdtemp(prefix="scan2cap_export_")
        data, _, val = write_scannet_fixture(
            np, root, points=3000 if rehearse else CLI_SCENE_POINTS)
        out = os.path.join(root, "outputs")
    else:
        root, data, out, val = (kept[k] for k in ("root", "data", "outputs",
                                                  "val"))
    env = dict(os.environ, SCAN2CAP_DATA=data, SCAN2CAP_OUTPUT=out,
               PYTHONPATH=ROOT)
    env.pop("SCAN2CAP_TEST_TINY", None)
    if rehearse:
        env["SCAN2CAP_TEST_TINY"] = "1"
    saved_env = {k: os.environ.get(k) for k in
                 ("SCAN2CAP_DATA", "SCAN2CAP_OUTPUT", "SCAN2CAP_TEST_TINY")}
    report = dict(card=card)
    try:
        if own:
            flags = [*CLI_FLAGS, "--device", dev]
            if rehearse:
                flags += ["--num_points", "1024", "--num_proposals", "32"]
            run_entry_point("scan2cap_torch.scripts.train",
                            [*flags, "--epoch", "1", "--val_step", "1000",
                             "--tag", "export"], env, logs)
            run = next(d for d in os.listdir(out) if d.endswith("_EXPORT"))
        else:
            run = kept["run"]
        os.environ.update({k: env[k] for k in ("SCAN2CAP_DATA",
                                               "SCAN2CAP_OUTPUT")})
        if rehearse:
            os.environ["SCAN2CAP_TEST_TINY"] = "1"
        folder = os.path.join(out, run)
        art = os.path.join(root, "model.pt2")
        t0 = time.perf_counter()
        serve, cfg, idx2word = export_model.build_serve(folder, dev)
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ep = export_model.export(serve, EXPORT_BATCH)
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        export_model.save(ep, art, idx2word)
        save_s = time.perf_counter() - t0
        del ep
        reset_launch_counts()
        t0 = time.perf_counter()
        module, checked = export_model.main(["--load", art, "--check",
                                             "--device", dev])
        load_s = time.perf_counter() - t0
        require(all(bool(torch.isfinite(checked[k]).all())
                    for k in EXPORT_KEYS[1:]), "--check: outputs not finite")

        with open(os.path.join(data, "ScanRefer_filtered_val.json")) as f:
            entries = [e for e in json.load(f) if e["scene_id"] == val[0]]
        ds = ScannetReferenceDataset(entries[:1], [val[0]], split="val",
                                     **dataset_kwargs(PathConfig(), cfg))
        pc = torch.from_numpy(np.asarray(ds.__getitem__(
            0, rs=np.random.RandomState(0))["point_clouds"]))[None].to(dev)
        with torch.no_grad():
            # the eager forward's every output (Serve keeps four), for the
            # stage where the card and the CPU part below
            card_full = serve.model(serve.batch(pc), use_tf=False,
                                    is_eval=True, train=False)
            eager = export_model.Serve.outputs(card_full)
            reset_launch_counts()
            with TieProof(torch) as card_calls:
                if dev == "cuda":
                    with HeldAgainstPlain(torch) as held:
                        loaded = module(pc)
                    torch.cuda.synchronize()
                else:
                    held, loaded = None, module(pc)
            per_forward = {k: v for k, v in launch_counts().items() if v}
            for k in EXPORT_KEYS:
                require(loaded[k].dtype == eager[k].dtype
                        and torch.equal(loaded[k], eager[k]),
                        f"export: the loaded program's {k} differs from the "
                        f"eager forward's")
            if held is not None:
                by_kernel = held.counts()
                want = dict(furthest_point_sample_cuda=5, ball_query_cuda=5,
                            group_points_cuda=6)
                require(by_kernel == per_forward == want, f"export: the "
                        f"loaded program held {by_kernel}, launched "
                        f"{per_forward}, want {want}")
            # each called once above
            ms = dict(eager=host_ms(torch, lambda: serve(pc),
                                    EXPORT_REQUESTS, torch.device(dev)),
                      loaded=host_ms(torch, lambda: module(pc),
                                     EXPORT_REQUESTS, torch.device(dev)))
            launches = launch_counts()
            # the same artifact on the CPU, against the port's CPU forward
            t0 = time.perf_counter()
            cpu_module = export_model.load(art, "cpu")
            with TieProof(torch) as cpu_calls:
                cpu_loaded = cpu_module(pc.cpu())
            cpu_loaded_s = time.perf_counter() - t0
            cpu_serve = export_model.build_serve(folder, "cpu")[0]
            cpu_full = cpu_serve.model(cpu_serve.batch(pc.cpu()),
                                       use_tf=False, is_eval=True,
                                       train=False)
            cpu_eager = export_model.Serve.outputs(cpu_full)
            # the card's eager forward against the CPU's, index entries
            # apart by stage; where the loaded programs' index stages part,
            # the CPU's program again from the card's picks, each part a
            # proven near tie
            stages = {k: int((card_full[k].cpu() != cpu_full[k]).sum())
                      for k in EXPORT_STAGES if k in cpu_full}
            replayed, ties = prove_against_card(
                torch, card_calls, cpu_calls, lambda: cpu_module(pc.cpu()))
            overhead = op_overhead_us(torch) if dev == "cuda" else None
        cpu_err, cpu_agree = serving_gates(torch, cpu_loaded, cpu_eager,
                                           "tokens", "export (CPU)")
        against = cpu_loaded if replayed is None else replayed
        card_err, card_agree = serving_gates(torch, loaded, against,
                                             "tokens", "export (card "
                                             "against the CPU)")
        card_far = int(((loaded["bbox_corner"].cpu()
                         - against["bbox_corner"]).abs()
                        .amax(dim=(-1, -2)) > VIS_CORNER_TOL).sum())
        report.update(
            run=run, batch=EXPORT_BATCH, points=cfg.num_points,
            columns=3 + cfg.input_feature_dim, build_s=build_s,
            export_s=export_s, save_s=save_s, load_and_check_s=load_s,
            artifact_mb=os.path.getsize(art) / 1e6,
            ms_per_request=ms, launches_per_forward=per_forward,
            held=len(held.checked) if held is not None else 0,
            bitwise=True, cpu_bitwise=all(
                torch.equal(cpu_loaded[k], cpu_eager[k])
                for k in EXPORT_KEYS),
            cpu_corner_max_abs_err=cpu_err, cpu_agree=cpu_agree,
            cpu_load_and_forward_s=cpu_loaded_s,
            card_vs_cpu_corner_max_abs_err=card_err,
            card_vs_cpu_proposals_apart=card_far,
            card_vs_cpu_agree=card_agree,
            card_vs_cpu_index_entries_apart=stages,
            card_vs_cpu_replayed=replayed is not None,
            card_vs_cpu_proven_ties=ties["proven_ties"],
            op_overhead_us=overhead, launches=launches)
        del module, cpu_module, serve, cpu_serve
        release_card(torch)
        return report
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        if own:
            shutil.rmtree(root, ignore_errors=True)
        elif os.path.exists(os.path.join(root, "model.pt2")):
            os.remove(os.path.join(root, "model.pt2"))


def print_export(r):
    print(f"  export: {r['run']} at B={r['batch']} over {r['points']} points "
          f"x {r['columns']}: build {r['build_s']:.1f} s, export "
          f"{r['export_s']:.1f} s, save {r['save_s']:.1f} s, "
          f"{r['artifact_mb']:.1f} MB, load and --check "
          f"{r['load_and_check_s']:.1f} s; ms per request loaded "
          f"{r['ms_per_request']['loaded']:.2f} against eager "
          f"{r['ms_per_request']['eager']:.2f}; launches per forward "
          f"{r['launches_per_forward']} ({r['held']} held), bitwise equal "
          f"to eager; on the CPU bitwise {r['cpu_bitwise']}, agreement "
          f"{r['cpu_agree']}; card against CPU (gated) corners "
          f"{r['card_vs_cpu_corner_max_abs_err']:.2e}, "
          f"{r['card_vs_cpu_proposals_apart']} proposals apart, agreement "
          f"{r['card_vs_cpu_agree']}, index entries apart by stage "
          f"{r['card_vs_cpu_index_entries_apart']}, replayed from the "
          f"card's picks {r['card_vs_cpu_replayed']}, proven ties "
          f"{r['card_vs_cpu_proven_ties']}; op dispatch us "
          f"{r['op_overhead_us']}", flush=True)


# -------------------------------------------------------------------- phase 19
# the 2D baselines at their published widths: ResNet101 over 320 x 240
# renders and 64 x 64 crops (one target and three context boxes a render),
# hidden 512, GloVe 300, B=64 (three steps an epoch)
TWOD_TRAIN = 192
TWOD_VAL = 64
TWOD_BOXES = 4
# the renders also extracted on the CPU, and the tolerance of each stored
# vector against the CPU's: 1e-3 of its largest entry
TWOD_CPU_RENDERS = 24
TWOD_TOL = 1e-3
TWOD_EPOCHS = 2
TWOD_TIMED = 20
TWOD_WORDS = ["the", "a", "chair", "table", "is", "next", "to", "brown",
              "white", "wooden", "large", "small", "in", "of", "corner",
              "room", "near", "window", "door", "desk", "left", "right",
              "on", "black", "with", "sofa", "bed", "lamp", "shelf", "wall"]


def write_twod_fixture(np, root, n_train, n_val, seed=0):
    """Renders ``<sample_id>.jpg`` (320 x 240: noise and a few filled
    rectangles), their boxes (one target, ``TWOD_BOXES - 1`` context), the
    ScanRefer splits and a GloVe pickle of 300-d vectors.  Returns (data
    dir, renders dir, box JSON, train entries, val entries)."""
    import pickle
    from PIL import Image

    rs = np.random.RandomState(seed)
    data = os.path.join(root, "data")
    renders = os.path.join(root, "renders")
    os.makedirs(data)
    os.makedirs(renders)
    glove = {w: rs.randn(300).astype(np.float32)
             for w in TWOD_WORDS + ["pad_", "unk", "sos", "eos"]}
    with open(os.path.join(data, "glove.p"), "wb") as f:
        pickle.dump(glove, f)
    entries, boxes = [], {}
    for i in range(n_train + n_val):
        e = {"scene_id": f"scene{i // 4:04d}_00", "object_id": str(i % 4),
             "object_name": "chair", "ann_id": "0",
             "token": [TWOD_WORDS[j] for j in
                       rs.randint(0, len(TWOD_WORDS), rs.randint(5, 16))]}
        e["description"] = " ".join(e["token"])
        entries.append(e)
        sid = "{}-{}_{}".format(e["scene_id"], e["object_id"], e["ann_id"])
        img = (rs.rand(240, 320, 3) * 96).astype(np.uint8)
        bs = []
        for b in range(TWOD_BOXES):
            x1, y1 = int(rs.randint(0, 280)), int(rs.randint(0, 200))
            x2 = x1 + int(rs.randint(16, 120))
            y2 = y1 + int(rs.randint(16, 100))
            img[y1:y2, x1:x2] = rs.randint(96, 256, 3)
            bs.append({"box": [x1, y1, x2, y2], "is_target": b == 0})
        boxes[sid] = bs
        Image.fromarray(img).save(os.path.join(renders, sid + ".jpg"))
    path = os.path.join(root, "boxes.json")
    with open(path, "w") as f:
        json.dump(boxes, f)
    train, val = entries[:n_train], entries[n_train:]
    for name, split in (("train", train), ("val", val)):
        with open(os.path.join(data, f"ScanRefer_filtered_{name}.json"),
                  "w") as f:
            json.dump(split, f)
    return data, renders, path, train, val


def twod_call(argv, what):
    """``scan2cap_torch.twod.main.main(argv)`` in process, its output
    printed and returned beside its result."""
    import contextlib
    import io

    from scan2cap_torch.twod import main as twod_main
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        result = twod_main.main(argv)
    wall = time.perf_counter() - t0
    text = buf.getvalue()
    print("\n".join(f"    [{what}] {line}" for line in
                    text.strip().splitlines()[-4:]), flush=True)
    return result, text, wall


def twod_phase(torch, np, card, dev="cuda", rehearse=False):
    """``python -m scan2cap_torch.twod.main`` in process at full width: a
    seeded random ResNet101 in torchvision's layout written as a ``.pth``
    by the port (``twod.resnet.random_torchvision_state_dict``); ``--prep``
    of the fixture's renders on ``dev``, each stored vector of the first
    ``TWOD_CPU_RENDERS`` renders within ``TWOD_TOL`` of its largest entry
    of a ``--device cpu`` prep, the store tagged ``resnet:pth``; ``snt``
    and ``tdbu`` trained (``TWOD_EPOCHS`` epochs of 3 steps at B=64) and
    evaluated (the four scores), the retrieval bank; ResNet ms per image
    and per crop, ms per decoder step, the wall time."""
    import shutil
    import tempfile

    from scan2cap_torch.data.feature_store import open_feature_store
    from scan2cap_torch.twod import resnet
    from scan2cap_torch.twod.main import load_render

    t_phase = time.perf_counter()
    n_train, n_val, n_cpu, batch = ((8, 4, 4, 4) if rehearse else
                                    (TWOD_TRAIN, TWOD_VAL, TWOD_CPU_RENDERS,
                                     64))
    blocks, width = ((1, 1, 1, 1), 64) if rehearse else ((3, 4, 23, 3), 64)
    root = tempfile.mkdtemp(prefix="scan2cap_twod_")
    saved_env = {k: os.environ.get(k) for k in
                 ("SCAN2CAP_DATA", "SCAN2CAP_OUTPUT", "SCAN2CAP_2D_DATA")}
    report = dict(card=card)
    try:
        data, renders, boxes, train, val = write_twod_fixture(
            np, root, n_train, n_val)
        pth = os.path.join(root, "resnet101.pth")
        torch.save(resnet.random_torchvision_state_dict(blocks, width,
                                                        seed=0), pth)
        # the CPU's prep: the first renders, in a split of their own
        data_cpu = os.path.join(root, "data_cpu")
        shutil.copytree(data, data_cpu)
        for name, split in (("train", train[:n_cpu]), ("val", [])):
            with open(os.path.join(data_cpu,
                                   f"ScanRefer_filtered_{name}.json"),
                      "w") as f:
                json.dump(split, f)
        os.environ["SCAN2CAP_OUTPUT"] = os.path.join(root, "outputs")
        prep = ["--prep", "--images_root", renders, "--boxes", boxes,
                "--resnet_pth", pth]
        stores = {}
        for where, d, device in (("card", data, dev),
                                 ("cpu", data_cpu, "cpu")):
            os.environ["SCAN2CAP_DATA"] = d
            os.environ["SCAN2CAP_2D_DATA"] = os.path.join(root, "2d_" + where)
            stores[where], _, report[f"prep_{where}_s"] = twod_call(
                [*prep, "--device", device], f"prep {where}")
        worst = 0.0
        with open_feature_store(stores["card"]) as got, \
                open_feature_store(stores["cpu"]) as want:
            require(got.attrs.get("extractor_backend") == "resnet:pth" ==
                    want.attrs.get("extractor_backend"),
                    f"twod: the stores are tagged {got.attrs}, {want.attrs}")
            require(len(got) == 3 * (n_train + n_val) and
                    set(want.keys()) <= set(got.keys()),
                    f"twod: {len(got)} keys on the card, {len(want)} on the "
                    f"CPU")
            for k in sorted(want.keys()):
                a, b = got[k], want[k]
                require(a.shape == b.shape and np.isfinite(a).all(),
                        f"twod: {k} {a.shape} against {b.shape}")
                if b.size:
                    err = float(np.abs(a - b).max() / np.abs(b).max())
                    worst = max(worst, err)
                    require(err <= TWOD_TOL, f"twod: {k} differs from the "
                            f"CPU's by {err} of its largest entry")
            report["stored_keys"] = len(got)
        report["cpu_checked_keys"] = 3 * n_cpu
        report["max_rel_err_vs_cpu"] = worst

        # the extractor alone: ms per render and per crop on the card
        extract = resnet.make_pth_extractor(pth, device=dev)
        img = load_render(renders, "{}-{}_{}".format(
            train[0]["scene_id"], train[0]["object_id"], train[0]["ann_id"]))
        crop = np.ascontiguousarray(img[:64, :64])
        for name, x in (("image", img[None]), ("crop", crop[None])):
            extract(x)
            report[f"resnet_ms_per_{name}"] = host_ms(
                torch, lambda: extract(x), TWOD_TIMED, torch.device(dev))
        del extract
        release_card(torch)

        os.environ["SCAN2CAP_DATA"] = data
        os.environ["SCAN2CAP_2D_DATA"] = os.path.join(root, "2d_card")
        common = ["--batch_size", str(batch), "--tag", "smoke", "--device",
                  dev]
        report["decoders"] = {}
        for model in ("snt", "tdbu"):
            _, text, train_s = twod_call(
                ["--train", "--epoch", str(TWOD_EPOCHS), "--model", model,
                 *common], f"train {model}")
            losses = [float(line.split(" loss ")[1].split()[0])
                      for line in text.splitlines() if " loss " in line]
            require(losses and all(np.isfinite(losses)),
                    f"twod {model}: losses {losses}")
            ms = float(text.split(" ms per step median")[0].rsplit(", ", 1)[1])
            scores, _, eval_s = twod_call(
                ["--eval", "--model", model, *common], f"eval {model}")
            require(all(np.isfinite(scores[k]) for k in
                        ("bleu-4", "cider", "rouge", "meteor")),
                    f"twod {model}: scores {scores}")
            report["decoders"][model] = dict(
                ms_per_step=ms, losses=losses, train_s=train_s,
                eval_s=eval_s, scores={k: scores[k] for k in
                                       ("bleu-4", "cider", "rouge",
                                        "meteor")})
        bank, _, report["retrieval_s"] = twod_call(
            ["--train", "--model", "retr", "--device", dev], "retr")
        require(len(bank.keys) == n_train, f"twod: a bank of "
                f"{len(bank.keys)} samples, want {n_train}")
        report.update(renders=n_train + n_val, boxes_per_render=TWOD_BOXES,
                      resnet_blocks=list(blocks), batch=batch,
                      bank=len(bank.keys),
                      wall_s=time.perf_counter() - t_phase)
        release_card(torch)
        return report
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(root, ignore_errors=True)


def print_twod(r):
    d = r["decoders"]
    print(f"  twod: {r['renders']} renders of 320 x 240, "
          f"{r['boxes_per_render']} boxes each, ResNet {r['resnet_blocks']}: "
          f"prep {r['prep_card_s']:.1f} s on the card, "
          f"{r['prep_cpu_s']:.1f} s on the CPU for {r['cpu_checked_keys']} "
          f"keys (largest difference {r['max_rel_err_vs_cpu']:.2e} of a "
          f"vector's largest entry); ResNet {r['resnet_ms_per_image']:.2f} "
          f"ms per image, {r['resnet_ms_per_crop']:.2f} ms per crop; "
          + "; ".join(f"{m} {v['ms_per_step']:.2f} ms per step at B="
                      f"{r['batch']}, scores {v['scores']}"
                      for m, v in d.items())
          + f"; retrieval bank {r['bank']}; wall {r['wall_s']:.1f} s",
          flush=True)


# -------------------------------------------------------------------- phase 15
# the bfloat16 backbone: train steps of the flagship at B=2 in each mode
BF16_MODES = (("compute", dict(compute_dtype="bfloat16")),
              ("storage", dict(storage_dtype="bfloat16")))
# step 1 on the card against the port's CPU run in bfloat16: the loss
# within 3e-2 relative and the whole gradient's norm within 5e-2 (the
# batch statistics' float32 sums, taken in another order on the card, round
# a few activations to the other bfloat16 neighbour; tests/test_torch_bf16.py
# measured what that does between two implementations); every index of the
# backbone exact
BF16_LOSS_TOL = 3e-2
BF16_NORM_TOL = 5e-2
BF16_WINDOWS = 2
BF16_STEPS = 10
BF16_DEMO_STEPS = 15
BF16_QUALITY_STEPS = 10


class PlainRecorder:
    """While open, the CPU's FPS and first-k (the plain versions the ops
    call on a CPU tensor) keep their results, by kernel, in call order."""

    def __init__(self):
        from scan2cap_torch.ops import grouping, sampling
        self.grouping, self.sampling = grouping, sampling
        self.outputs = {}

    def __enter__(self):
        s, g = self.sampling, self.grouping
        self.saved = (s.furthest_point_sample_plain, g.ball_query_plain)

        def keep(kernel, fn):
            def call(*args, **kw):
                out = fn(*args, **kw)
                self.outputs.setdefault(kernel, []).append(out.clone())
                return out
            return call

        s.furthest_point_sample_plain = keep("furthest_point_sample_cuda",
                                             self.saved[0])
        g.ball_query_plain = keep("ball_query_cuda", self.saved[1])
        return self

    def __exit__(self, *exc):
        self.sampling.furthest_point_sample_plain, \
            self.grouping.ball_query_plain = self.saved


BF16_BATCH = 2


def bf16_config(mode, rehearse=False):
    """The flagship of phase 5 in ``mode`` (``BF16_MODES``); a small one
    to rehearse on the CPU."""
    import dataclasses

    from scan2cap_torch.config import flagship_config
    base = flagship_config(min_iou=0.0, **dict(BF16_MODES)[mode])
    if rehearse:
        base = dataclasses.replace(base, num_points=2048,
                                   sa_npoints=(256, 128, 64, 32),
                                   num_proposals=32, hidden_size=64,
                                   emb_size=32)
    return base


def bf16_model(cfg, device):
    """The seeded, conditioned flagship and its train step."""
    import torch

    from scan2cap_torch.models import CapNet
    from scan2cap_torch.train.step import create_train_state, make_train_step
    model = CapNet(cfg, num_vocabs=NUM_VOCABS, device=device, seed=0)
    condition_weights(torch, model)
    state = create_train_state(cfg, model)
    return model, make_train_step(cfg, state, **TRAIN_LOSSES)


def bf16_cpu_step(mode, rehearse=False, lr=1e-3, bn_momentum=0.1,
                  threads=None):
    """Step 1 of the bfloat16 phase's model in ``mode`` on the CPU: its
    metrics, gradient norms and the plain FPS and first-k outputs.  Runs
    in a process of its own too (``bf16_cpu_steps``), on ``threads``
    torch threads."""
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    from scan2cap_torch.data.synthetic import to_device
    if threads:
        torch.set_num_threads(threads)
    cfg = bf16_config(mode, rehearse)
    host = flagship_batch(np, cfg, BF16_BATCH)
    model, step = bf16_model(cfg, "cpu")
    with PlainRecorder() as rec:
        first = {k: float(v) for k, v in step(
            to_device(host, "cpu"), lr, bn_momentum).items()}
    return first, grad_norms(model), rec.outputs


def bf16_cpu_steps():
    """``bf16_cpu_step`` of each mode started at once, each in a spawned
    process on its share of the host's cores less one (a CPU step spends
    much of its time in one thread); the pool and the futures by mode."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    pool = ProcessPoolExecutor(len(BF16_MODES),
                               mp_context=multiprocessing.get_context(
                                   "spawn"))
    threads = max(1, (os.cpu_count() or 2) // len(BF16_MODES) - 1)
    return pool, {mode: pool.submit(bf16_cpu_step, mode, threads=threads)
                  for mode, _ in BF16_MODES}


def bf16_phase(torch, np, card, dev="cuda", rehearse=False, float32=None,
               lr=1e-3, bn_momentum=0.1, cpu_steps=None):
    """The bfloat16 backbone on the flagship at B=2, each mode
    (``BF16_MODES``): step 1 with every FPS, first-k and gather launch
    held against its plain version and receiving float32 (5, 5, 6);
    step 1 on the CPU from the same weights (the backbone's FPS and
    first-k indices exact, the vote stage's share of differing indices
    reported, the loss and the gradient's norm within ``BF16_LOSS_TOL`` and
    ``BF16_NORM_TOL``); ms per step over ``BF16_WINDOWS`` spans, kernel ms
    and busy share of a profiled step, beside phase 5's float32 step
    (``float32``); ``demo_synthetic_train --bf16`` and
    ``quality_trajectory --bf16_storage`` as subprocesses, beside the CPU's
    steps (the card's steps run after both, alone).  ``rehearse`` runs a
    small model on the CPU."""
    from concurrent.futures import ThreadPoolExecutor

    from scan2cap_torch.data.synthetic import to_device
    from scan2cap_torch.kernels import launch_counts, reset_launch_counts

    report = dict(card=card, modes={})
    total = dict.fromkeys(launch_counts(), 0)
    # the entry points on the card beside the CPU's step 1 of each mode
    # (``cpu_steps``: started in processes of their own before this phase,
    # else here), so their timers are taken beside them
    with ThreadPoolExecutor(1) as pool:
        entry_points = pool.submit(bf16_entry_points, np, dev, rehearse)
        cpu = {mode: (cpu_steps[mode].result() if cpu_steps
                      else bf16_cpu_step(mode, rehearse, lr, bn_momentum))
               for mode, _ in BF16_MODES}
        done = entry_points.result()
    for mode, dtypes in BF16_MODES:
        cfg = bf16_config(mode, rehearse)
        cpu_first, cpu_norms, cpu_outputs = cpu[mode]
        row = dict(batch=BF16_BATCH, **dtypes)
        if dev == "cpu":
            row["step1"] = cpu_first
            report["modes"][mode] = row
            continue
        model, step = bf16_model(cfg, dev)
        host = flagship_batch(np, cfg, BF16_BATCH)
        batch = to_device(host, dev)
        reset_launch_counts()
        with HeldAgainstPlain(torch, record=True) as held:
            first = step(batch, lr, bn_momentum)
        torch.cuda.synchronize()
        first = {k: float(v) for k, v in first.items()}
        per_step = {k: v for k, v in launch_counts().items() if v}
        by_kernel = held.counts()
        want = dict(furthest_point_sample_cuda=5, ball_query_cuda=5,
                    group_points_cuda=6)
        require(by_kernel == want and per_step == want,
                f"bf16 {mode}: held {by_kernel}, launched {per_step}")
        require(all(np.isfinite(v) for v in first.values()),
                f"bf16 {mode} step 1: {first}")
        for k, v in per_step.items():
            total[k] = total.get(k, 0) + v
        # indices: the backbone's sites exact, the vote stage reported
        vote_diff = {}
        for kernel in ("furthest_point_sample_cuda", "ball_query_cuda"):
            got, want_ = held.outputs[kernel], cpu_outputs[kernel]
            require(len(got) == len(want_) == 5, f"bf16 {mode}: {kernel} "
                    f"{len(got)} on the card, {len(want_)} on the CPU")
            for i in range(4):
                require(torch.equal(got[i], want_[i].to(got[i].dtype)),
                        f"bf16 {mode}: {kernel} at the backbone's site "
                        f"{i + 1} differs from the CPU's")
            vote_diff[kernel] = float((got[4] != want_[4].to(
                got[4].dtype)).float().mean())
        loss_rel = abs(first["loss"] - cpu_first["loss"]) / abs(
            cpu_first["loss"])
        card_norms = grad_norms(model)
        whole = [float(np.sqrt(sum(v * v for v in n.values())))
                 for n in (card_norms, cpu_norms)]
        norm_rel = abs(whole[0] - whole[1]) / whole[1]
        worst = max(cpu_norms, key=lambda n: abs(card_norms[n] - cpu_norms[n])
                    / max(cpu_norms[n], 1e-6 * whole[1]))
        require(loss_rel <= BF16_LOSS_TOL, f"bf16 {mode} step-1 loss: card "
                f"{first['loss']} vs CPU {cpu_first['loss']}")
        require(norm_rel <= BF16_NORM_TOL, f"bf16 {mode} gradient norm: "
                f"card {whole[0]} vs CPU {whole[1]}")
        # ms per step, then a profiled step
        step(batch, lr, bn_momentum)
        torch.cuda.synchronize()
        window_ms = []
        for _ in range(BF16_WINDOWS):
            t0 = time.perf_counter()
            for _ in range(BF16_STEPS):
                loss = step(batch, lr, bn_momentum)["loss"]
            float(loss)
            window_ms.append((time.perf_counter() - t0) * 1e3 / BF16_STEPS)
        ms = sorted(window_ms)[len(window_ms) // 2]
        profile = profile_step(lambda: step(batch, lr, bn_momentum),
                               f"bf16 {mode}")
        row.update(
            step1=dict(loss=first["loss"], cpu_loss=cpu_first["loss"],
                       loss_rel=loss_rel, grad_norm=whole[0],
                       cpu_grad_norm=whole[1], grad_norm_rel=norm_rel,
                       worst_tensor=worst,
                       worst_tensor_rel=abs(card_norms[worst]
                                            - cpu_norms[worst])
                       / max(cpu_norms[worst], 1e-6 * whole[1])),
            held=len(held.checked), launches_per_step=per_step,
            vote_stage_indices_differing=vote_diff,
            window_ms_per_step=window_ms, ms_per_step=ms,
            kernel_ms=profile["kernel_ms"],
            busy_share=profile["kernel_ms"] / ms, top=profile["top"],
            loss_after=float(loss))
        if float32 is not None:
            row["float32"] = dict(
                ms_per_step=float32["ms_per_step"],
                kernel_ms=float32["profile"]["kernel_ms"],
                busy_share=float32["profile"]["busy_share_of_steady_step"])
        report["modes"][mode] = row
        del model, step, batch, held
        release_card(torch)

    report.update(done)
    steps = done["trajectory"]["steps"]
    for k, v in done["trajectory"]["launches_per_step"].items():
        total[k] = total.get(k, 0) + v * steps
    for k, v in done["trajectory"]["eval_launches"].items():
        total[k] = total.get(k, 0) + v
    report["launches"] = total
    return report


def bf16_entry_points(np, dev, rehearse):
    """The bfloat16 phase's entry points at once: ``demo_synthetic_train
    --bf16`` and ``quality_trajectory --bf16_storage``; their readings."""
    import shutil
    import tempfile

    logs = os.path.join(ROOT, "chiprun_out", "bf16")
    os.makedirs(logs, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("SCAN2CAP_TEST_TINY", None)
    tmp = tempfile.mkdtemp(prefix="scan2cap_bf16_")
    try:
        demo_size = (["--steps", "20", "--batch_size", "2", "--num_points",
                      "2048", "--num_batches", "1"] if rehearse
                     else ["--steps", str(BF16_DEMO_STEPS)])
        out = os.path.join(tmp, "trajectory.json")
        size = (["--tiny", "--steps", "4", "--eval_every", "2",
                 "--batch_size", "2", "--num_batches", "1", "--num_points",
                 "512"] if rehearse else
                ["--steps", str(BF16_QUALITY_STEPS), "--eval_every",
                 str(BF16_QUALITY_STEPS // 2)])
        # the demo and the trajectory at once: their step times overlap
        (text, wall), (_, traj_wall) = run_together(
            entry_job("scan2cap_torch.scripts.demo_synthetic_train",
                      [*demo_size, "--bf16", "--device", dev], env, logs),
            entry_job("scan2cap_torch.scripts.quality_trajectory",
                      [*size, "--bf16_storage", "--eval_batches", "1",
                       "--out", out, "--device", dev], env, logs))
        demo = json.loads(next(l for l in text.splitlines()[::-1]
                               if l.startswith('{"demo"')))["demo"]
        require(demo["compute_dtype"] == "bfloat16"
                and all(np.isfinite([demo["first"]["loss"],
                                     demo["last"]["loss"]])),
                f"the bf16 demo: {demo['first']} -> {demo['last']}")
        report = {}
        report["demo"] = dict(wall_s=wall, steps=demo["steps"],
                              first=demo["first"]["loss"],
                              last=demo["last"]["loss"], map25=demo["map25"],
                              ar25=demo["ar25"],
                              scenes_per_s=demo["scenes_per_sec"])
        with open(out) as f:
            traj = json.load(f)
        losses = [x for x in traj["curve"]["loss"] if x is not None]
        require(traj["config"]["storage_dtype"] == "bfloat16"
                and all(np.isfinite(losses)),
                f"the bf16-storage trajectory: {traj['curve']['loss']}")
        per = traj["launches_per_step"]
        require(rehearse or per == dict(furthest_point_sample_cuda=5,
                                        ball_query_cuda=5,
                                        group_points_cuda=6),
                f"the bf16-storage trajectory's launches per step {per}")
        report["trajectory"] = dict(wall_s=traj_wall, curve=traj["curve"],
                                    ms_per_step=traj["ms_per_step"],
                                    launches_per_step=per,
                                    steps=traj["config"]["steps"],
                                    eval_launches=traj["eval_launches"])
        return report
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def print_tools(r):
    v, e, p = r["visualize"], r["export"], r["preparation"]
    print(f"  tools: export {e['wall_s']} s ({e['tensors']} tensors read "
          f"back bit-equal); visualize {v['scene']} {v['card_s']:.1f} s on "
          f"the card ({v['held']} launches held), {v['cpu_s']:.1f} s on the "
          f"CPU, {v['kept']} boxes kept on the card, {v['kept_cpu']} on the "
          f"CPU, {v['kept_differ']} kept by one run only; corners "
          f"{v['corner_max_abs_err']:.2e} apart, agreement {v['agree']}; "
          f"index entries apart {v['index_entries_apart']}, proven ties "
          f"{v['proven_ties']}; files {v['files']}; preparation "
          f"{p['wall_s']}", flush=True)


def print_bf16(r):
    for mode, row in r["modes"].items():
        s1 = row["step1"]
        print(f"  bf16 {mode}: step 1 loss {s1.get('loss')} (CPU "
              f"{s1.get('cpu_loss')}), {row.get('ms_per_step')} ms per step "
              f"(float32 {row.get('float32', {}).get('ms_per_step')}), "
              f"kernels {row.get('kernel_ms')} ms, busy "
              f"{row.get('busy_share')}, vote-stage indices differing "
              f"{row.get('vote_stage_indices_differing')}", flush=True)
    print(f"  bf16 demo {r['demo']}; storage trajectory "
          f"{r['trajectory']['ms_per_step']} ms per step", flush=True)


def print_quality(r):
    t, d = r["trajectory"], r["demo"]
    print(f"  quality: held step {r['held_step']['by_kernel']} exact; "
          f"trajectory {t['steps']} steps, {t['ms_per_step']} ms per step "
          f"({t['scenes_per_s']} scenes/s), eval s per record "
          f"{t['eval_s_per_record']}, launches per step "
          f"{t['launches_per_step']}, {t['wall_s']:.1f} s", flush=True)
    for key in ("step", "loss", "map25", "ar25", "cider_train"):
        print(f"    {key}: {t['curve'][key]}", flush=True)
    print(f"  demo: {d['steps']} steps, {d['logged']}, mAP@0.25 "
          f"{d['map25']:.4f}, {d['scenes_per_s']:.2f} scenes/s, "
          f"{d['wall_s']:.1f} s", flush=True)


def print_multiview(r):
    print(f"  multiview: {r['enet']['frames']} frames, ENet "
          f"{r['enet_frames_per_s']:.1f} frames/s, "
          f"{r['enet_ms_per_batch']:.1f} ms per batch of "
          f"{r['enet']['batch_size']} ({r['enet_ms_per_warm_batch']:.1f} "
          f"warm; vs the CPU {r['enet_max_rel_err']:.2e} "
          f"of the largest value); projection "
          f"{r['projection_ms_per_frame']:.1f} ms per frame, points covered "
          f"{r['points_covered']}, store {r['store_bytes']} bytes; labelled "
          f"{r['labelled_points']}; training losses {r['train_losses']}; "
          f"entry points {r['entry_point_wall_s']}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel checks (phase 3)")
    ap.add_argument("--skip", nargs="+", default=[],
                    choices=["serve", "train", "eval", "probes", "cli",
                             "mesh", "multicard", "export", "mvn",
                             "benchmark", "pretrained", "quality",
                             "multiview", "tools", "bf16", "twod"],
                    help="leave out a path while bringing up another "
                         "(exit 3 by design: not a whole run)")
    ap.add_argument("--cards", type=int, default=None,
                    help="the multicard phase's cards (default: every card "
                         "present; it runs with two or more); fewer cards "
                         "present than asked for is an error")
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
    cards = torch.cuda.device_count()
    if args.cards is not None and args.cards > cards:
        print(f"chip_smoke: --cards {args.cards}, but {cards} present",
              file=sys.stderr)
        return 1
    cards = args.cards or cards

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
    serve = train = evaluation = probes = cli = mvn = bench = pre = None
    quality = multiview = tools = bf16 = kept = mesh = None
    exported = twod = multicard = None
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
            # the mesh phase trains on the fixture, the export and tools
            # phases read the resumed run; the last of them removes the
            # fixture
            cli = cli_phase(torch, np, card, keep=not {"tools", "mesh",
                                                       "multicard", "export"}
                            <= set(args.skip))
            kept = cli.pop("kept")
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
        if "mesh" not in args.skip:
            t0 = time.perf_counter()
            mesh = mesh_phase(torch, np, card, kept=kept)
            paths["mesh"] = mesh["launches"]
            print_mesh(mesh)
            print(f"mesh phase: {time.perf_counter() - t0:.1f} s",
                  flush=True)
        if "multicard" not in args.skip and cards < 2:
            multicard = dict(ran=False, cards=cards)
        elif "multicard" not in args.skip:
            t0 = time.perf_counter()
            reset_launch_counts()
            multicard = multicard_phase(torch, np, card, cards, kept=kept)
            # the kernels on the other cards from this process, and every
            # rank's
            paths["multicard"] = sum_launches(launch_counts(),
                                              multicard["launches"])
            print_multicard(multicard)
            print(f"multicard phase: {time.perf_counter() - t0:.1f} s",
                  flush=True)
        if "export" not in args.skip:
            t0 = time.perf_counter()
            reset_launch_counts()
            exported = export_phase(torch, np, card, kept=kept)
            paths["export"] = exported["launches"]
            print_export(exported)
            print(f"export phase: {time.perf_counter() - t0:.1f} s",
                  flush=True)
        if kept is not None and "tools" in args.skip:
            import shutil
            shutil.rmtree(kept["root"], ignore_errors=True)
            kept = None
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
        if "pretrained" not in args.skip:
            t0 = time.perf_counter()
            reset_launch_counts()
            pre = pretrained_phase(torch, np)
            # in process (the held extraction forwards, the encoder) and
            # the entry points' own counts
            pre["launches"] = sum_launches(launch_counts(),
                                           pre["cli"]["launches"])
            paths["pretrained"] = pre["launches"]
            print_pretrained(pre)
            print(f"pretrained phase: {time.perf_counter() - t0:.1f} s",
                  flush=True)
        # the bf16 phase's CPU steps start here, in processes of their own,
        # and run beside the quality, multiview and tools phases
        bf16_pool, bf16_cpu = (bf16_cpu_steps() if "bf16" not in args.skip
                               else (None, None))
        if "quality" not in args.skip:
            t0 = time.perf_counter()
            reset_launch_counts()
            quality = quality_phase(torch, np, card)
            # the held step in process and the trajectory's own counts
            quality["launches"] = sum_launches(launch_counts(),
                                               quality["launches"])
            paths["quality"] = quality["launches"]
            print_quality(quality)
            print(f"quality phase: {time.perf_counter() - t0:.1f} s",
                  flush=True)
        if "multiview" not in args.skip:
            t0 = time.perf_counter()
            reset_launch_counts()
            multiview = multiview_phase(torch, np, card)
            multiview["launches"] = sum_launches(launch_counts(),
                                                 multiview["launches"])
            paths["multiview"] = multiview["launches"]
            print_multiview(multiview)
            print(f"multiview phase: {time.perf_counter() - t0:.1f} s",
                  flush=True)
        if "tools" not in args.skip:
            t0 = time.perf_counter()
            reset_launch_counts()
            tools = tools_phase(torch, np, card, kept=kept)
            paths["tools"] = tools["launches"]
            print_tools(tools)
            print(f"tools phase: {time.perf_counter() - t0:.1f} s",
                  flush=True)
        if "bf16" not in args.skip:
            t0 = time.perf_counter()
            reset_launch_counts()
            bf16 = bf16_phase(torch, np, card, float32=train,
                              cpu_steps=bf16_cpu)
            bf16_pool.shutdown()
            paths["bf16"] = bf16["launches"]
            print_bf16(bf16)
            print(f"bf16 phase: {time.perf_counter() - t0:.1f} s",
                  flush=True)
        if "twod" not in args.skip:
            t0 = time.perf_counter()
            reset_launch_counts()
            twod = twod_phase(torch, np, card)
            paths["twod"] = launch_counts()
            print_twod(twod)
            print(f"twod phase: {time.perf_counter() - t0:.1f} s",
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
    if mesh is not None:
        print(json.dumps({"mesh": mesh, "card": card}))
    if multicard is not None:
        print(json.dumps({"multicard": multicard, "card": card}))
    if exported is not None:
        print(json.dumps({"export": exported, "card": card}))
    if mvn is not None:
        print(json.dumps({"mvn": mvn, "card": card}))
    if bench is not None:
        print(json.dumps({"benchmark": bench, "card": card}))
    if pre is not None:
        print(json.dumps({"pretrained": pre, "card": card}))
    if quality is not None:
        print(json.dumps({"quality": quality, "card": card}))
    if multiview is not None:
        print(json.dumps({"multiview": multiview, "card": card}))
    if tools is not None:
        print(json.dumps({"tools": tools, "card": card}))
    if bf16 is not None:
        print(json.dumps({"bf16": bf16, "card": card}))
    if twod is not None:
        print(json.dumps({"twod": twod, "card": card}))
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
