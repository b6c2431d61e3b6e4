"""One sharded eval and train step of the port across cards, held against
one card (the counterpart of ``__graft_entry__.dryrun_multichip``).

    python -m scan2cap_torch.scripts.dryrun_multicard --cards N \\
        [--device cuda|cpu] [--json PATH]

On the card each of the N ranks is a process on ``cuda:<rank>`` over NCCL,
started by ``parallel.mesh.launch``; ``--device cpu`` runs N gloo ranks at
the tiny configuration (``flagship_cfg(tiny=True)``, the JAX dryrun's own
tiny stage).  Before the ranks start, this process computes the one-card
reference and releases the card.  The ranks then run every stage in one
launch, each mesh shape a ``parallel.mesh.sub_mesh`` of the N ranks:

* flagship: the flagship CapNet (multiview, normal and height over 40,000
  points, 2 graph steps, 10 locals, top-down, relation and orientation,
  256 proposals, 3,433 words) with seeded weights (two layers scaled into
  a trained model's range, ``condition_weights``), a synthetic batch of
  B=8 rounded up to the data axes, on the mesh (N/2, 2), as the JAX dryrun
  picks it, and on (N, 1): the eval tokens at least 99% equal to one
  card's (exact expected; each differing token listed with its scene and
  proposal), corners within 1e-3, the sa1 indices exact (the later
  stages' differing picks counted), one train step's loss within 2e-3
  relative of one card's and every whole gradient's norm within 1e-2; the
  collective calls and bytes of the eval and of the step by axis.  On the
  card every rank holds its step's FPS, first-k and gather launches
  against their plain versions on its own card (5, 5 and 6 a step).
* spatial: the backbone at B=2 over 80,000 points with the SA query axis
  over the N ranks, (1, N): sa1, sa2 and fp2 indices exact against the
  unsharded backbone on one card, fp2 features within 2e-5 of their
  scale, no collective issued by FPS.
* dp_spatial: the same backbone on (2, N/2), the scenes over the data axis
  and the query axis over the model axis: no data-axis collective, the
  bytes a rank receives below one scene table (B x N x (3 + C) x 4), the
  indices of each rank's scene exact.
* other cards (on the card): from the parent, after card 0 has launched
  them, each other card launches FPS at 100,000 and 200,000 points (the
  16-block and shared-state tiers, whose launches set per-card kernel
  attributes) and both pack-tile probes, held exactly against their plain
  versions, and FPS, the first-k and the gather at 8,192 points.
* timing: ms per train step
  at (1,1), (2,1), (4,1), (2,2) and (1,4), those that N holds, at a global
  B=8 and at B=8 per data rank, and from one traced step per rank its
  NCCL kernels' ms and count and its collectives.

With one card every mesh is (1, 1): each collective is then elided, and
the dp_spatial stage, which needs two data ranks, is not run.  Prints one
JSON line (``--json`` writes it to a file too); exits 1 when a gate
fails, naming it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

NUM_VOCABS = 3433            # ScanRefer's train vocabulary
TINY_VOCABS = 64
LOSSES = dict(detection=True, caption=True, orientation=True, distance=True)
LR, BN_MOMENTUM = 1e-3, 0.1
STAGES = ("sa1_inds", "sa2_inds", "sa3_inds", "sa4_inds",
          "aggregated_vote_inds")
EVAL_KEYS = ("lang_cap", "bbox_corner") + STAGES
SPATIAL_KEYS = ("sa1_inds", "sa2_inds", "fp2_inds")
# gates: the serving gate of the port's card runs, JAX's own bounds
TOKEN_AGREE = 0.99
CORNER_TOL = 1e-3
LOSS_REL = 2e-3
NORM_REL = 1e-2
FEATURE_REL = 2e-5
# the spatial stage: twice the flagship's 40,000 points (the JAX stage's)
SPATIAL_B, SPATIAL_N, TINY_SPATIAL_N = 2, 80000, 1024
TIMING_SHAPES = ((1, 1), (2, 1), (4, 1), (2, 2), (1, 4))
TIMING_BATCH = 8
TIMING_WARMUP, TIMING_STEPS = 1, 4
LISTED = 50                  # differing tokens listed per mesh


def flagship_cfg(tiny: bool = False):
    """``__graft_entry__._flagship_cfg``: the flagship's widths, or the
    JAX dryrun's tiny stage."""
    from scan2cap_torch.config import ModelConfig
    if tiny:
        return ModelConfig(
            num_points=256, num_proposals=16, sa_npoints=(64, 32, 16, 16),
            max_num_obj=8, num_locals=4, num_graph_steps=2,
            use_topdown=True, use_relation=True, use_orientation=True,
            use_normal=True, use_multiview=False, min_iou=-1.0)
    return ModelConfig(
        num_graph_steps=2, num_locals=10, use_topdown=True,
        use_relation=True, use_orientation=True, use_normal=True,
        use_multiview=True)


def mesh_shapes(n: int) -> List[tuple]:
    """(N/2, 2) as the JAX dryrun picks it ((N, 1) for an odd N), then
    (N, 1)."""
    n_model = 2 if n % 2 == 0 and n > 1 else 1
    shapes = [(n // n_model, n_model)]
    if shapes[0] != (n, 1):
        shapes.append((n, 1))
    return shapes


def batch_size(n: int, tiny: bool) -> int:
    """The JAX dryrun's batch: 2N at the tiny size, else 8 rounded up to
    a multiple of every data axis."""
    if tiny:
        return 2 * n
    step = math.lcm(*(d for d, _ in mesh_shapes(n)))
    return -(-8 // step) * step


def flagship_batch(cfg, B: int, tiny: bool) -> Dict[str, np.ndarray]:
    from scan2cap_torch.data.synthetic import make_scene_batch, make_vocab
    V = TINY_VOCABS if tiny else NUM_VOCABS
    vocab = make_vocab(num_vocabs=V, emb_size=cfg.emb_size)
    return make_scene_batch(cfg, batch_size=B, num_objects=3 if tiny else 6,
                            vocab=vocab)


def spatial_inputs(cfg, tiny: bool) -> np.ndarray:
    """The JAX spatial stage's cloud: B=2 scenes, xyz in a 6 m cube and
    features of scale 0.1, from RandomState(11)."""
    N = TINY_SPATIAL_N if tiny else SPATIAL_N
    rs = np.random.RandomState(11)
    return np.concatenate(
        [rs.rand(SPATIAL_B, N, 3).astype(np.float32) * 6 - 3,
         (rs.randn(SPATIAL_B, N, cfg.input_feature_dim) * 0.1
          ).astype(np.float32)], axis=-1)


def condition_weights(model) -> None:
    """Bring two layers of the seeded random CapNet into a trained model's
    range (the same on every device): a fresh voting head throws its votes
    metres away, so that no proposal is a positive, and the sum-aggregated
    graph messages reach the hundreds, where float32 has 5 digits left and
    a step's gradients part at rounding."""
    with torch.no_grad():
        model.vgen.conv3.weight.mul_(0.02)
        for layer in (model.graph.gc_0, model.graph.gc_1,
                      model.graph.edge_layer):
            layer.map_edge_1.weight.mul_(0.1)


def build_capnet(cfg, V: int, device, weights=None):
    """The CapNet of ``weights``, or seeded and conditioned."""
    from scan2cap_torch.models import CapNet
    model = CapNet(cfg, num_vocabs=V, device=device, seed=0)
    if weights is None:
        condition_weights(model)
    else:
        model.load_state_dict(weights, strict=True)
    return model


def build_backbone(cfg, device, weights=None, spatial_axis: str = ""):
    from scan2cap_torch.models.backbone import Pointnet2Backbone
    from scan2cap_torch.models.layers import seeded_init
    net = Pointnet2Backbone(cfg.input_feature_dim, cfg.sa_npoints,
                            spatial_axis=spatial_axis)
    if weights is None:
        seeded_init(net, 0)
    else:
        net.load_state_dict(weights, strict=True)
    return net.to(device)


def eval_forward(model):
    """The eval forward's tokens, corners and index stages."""
    def forward(batch):
        model.eval()
        with torch.inference_mode():
            out = model(batch, use_tf=False, is_eval=True, train=False)
        return {k: out[k] for k in EVAL_KEYS if k in out}
    forward.per_scene_outputs = EVAL_KEYS
    return forward


def grad_norms(model) -> Dict[str, float]:
    """Each parameter's whole gradient's norm (a split one gathered over
    the model axis)."""
    from scan2cap_torch.parallel import mesh as pmesh
    dims = getattr(model, "shard_dims", {})
    out = {}
    for name, p in model.named_parameters():
        g = p.grad
        if name in dims:
            g = pmesh.all_gather(g, "model", dims[name])
        out[name] = float(g.double().norm())
    return out


def counted():
    """The collective counters now, to be read with ``since``."""
    from scan2cap_torch.parallel import mesh as pmesh
    return dict(pmesh.COLLECTIVES), dict(pmesh.COLLECTIVE_BYTES)


def since(mark) -> Dict[str, Dict[str, int]]:
    """Collective calls and bytes by axis since ``mark``."""
    from scan2cap_torch.parallel import mesh as pmesh
    calls, nbytes = mark
    return {axis: dict(calls=pmesh.COLLECTIVES[axis] - calls.get(axis, 0),
                       bytes=pmesh.COLLECTIVE_BYTES[axis]
                       - nbytes.get(axis, 0))
            for axis in ("data", "model", "world")}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def release() -> None:
    import gc
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


# ------------------------------------------------------------- one card
def flagship_reference(cfg, V, host, device, weights=None) -> Dict:
    """One card's eval outputs, then one train step's loss and gradient
    norms, from the same weights."""
    from scan2cap_torch.data.synthetic import to_device
    from scan2cap_torch.train.step import create_train_state, make_train_step
    model = build_capnet(cfg, V, device, weights)
    batch = to_device(host, device)
    out = {k: v.cpu() for k, v in eval_forward(model)(batch).items()}
    state = create_train_state(cfg, model)
    metrics = make_train_step(cfg, state, **LOSSES)(batch, LR, BN_MOMENTUM)
    out["loss"] = float(metrics["loss"])
    out["norms"] = grad_norms(model)
    return out


def spatial_reference(cfg, pc, device, weights=None) -> Dict:
    net = build_backbone(cfg, device, weights)
    with torch.no_grad():
        out = net({"point_clouds": torch.from_numpy(pc).to(device)},
                  train=False)
    return {k: out[k].cpu() for k in SPATIAL_KEYS + ("fp2_features",)}


# FPS at the two tiers above a cluster of 8 blocks, whose launches set
# per-card attributes first (csrc/fps.cu PerCard): the 16-block registers
# and the shared-state tier; picks per scene
CARD_ATTRIBUTE_FPS = ((100000, "cluster16"), (200000, "shared_state"))
CARD_ATTRIBUTE_PICKS = 512


def card_attributes(dev: torch.device) -> Dict:
    """On ``dev``: FPS at 100,000 and 200,000 points (B=2) in the tiers
    that set a kernel attribute before their launch, and both pack-tile
    probes (their shared-memory size), each held exactly against its plain
    version there.  Returns the launches by kernel."""
    from scan2cap_torch.kernels import fps as fps_kernel
    from scan2cap_torch.kernels import pack_probe
    from scan2cap_torch.ops import sampling
    from scan2cap_torch.probes import pack, shift
    g = torch.Generator().manual_seed(7)
    wrapper = fps_kernel.furthest_point_sample_cuda
    held = {}
    for n, tier in CARD_ATTRIBUTE_FPS:
        xyz = (torch.rand((2, n, 3), generator=g) * 8).to(dev)
        before = getattr(wrapper, f"{tier}_launches")
        got = wrapper(xyz, CARD_ATTRIBUTE_PICKS)
        if getattr(wrapper, f"{tier}_launches") != before + 1:
            raise RuntimeError(f"FPS at {n} points on {dev} did not run in "
                               f"the {tier} tier")
        if not torch.equal(got, sampling.furthest_point_sample_plain(
                xyz, CARD_ATTRIBUTE_PICKS)):
            raise RuntimeError(f"FPS at {n} points on {dev}: kernel != "
                               f"plain")
        held[f"fps_{tier}"] = 1
    _, hit, ints = pack.probe_tiles()[1]                 # density 0.3
    h, i = torch.from_numpy(hit).to(dev), torch.from_numpy(ints).to(dev)
    for name, got, want in (
            ("pack_probe", pack_probe.pack_probe_cuda(h),
             pack.pack_probe_plain(h)),
            ("shift_probe", pack_probe.shift_probe_cuda(h, i),
             shift.shift_probe_plain(h, i))):
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise RuntimeError(f"{name} on {dev}: kernel != plain")
        held[name] = 1
    torch.cuda.synchronize(dev)
    return held


def other_cards(n: int) -> List[Dict]:
    """From this process, whose current card is 0: the kernels whose
    launches set per-card attributes on card 0 first (``card_attributes``),
    then on each other card; and FPS, the first-k and the gather on
    tensors of each other card (the launch path's branch for a device
    that is not the current one), held against their plain versions on
    that card."""
    from scan2cap_torch.ops import grouping, sampling
    from scan2cap_torch.probes.held import HeldAgainstPlain
    rows = []
    card_attributes(torch.device("cuda", 0))
    g = torch.Generator().manual_seed(5)
    for i in range(1, n):
        dev = torch.device("cuda", i)
        xyz = (torch.rand((2, 8192, 3), generator=g) * 4).to(dev)
        table = torch.randn((2, 8192, 64), generator=g).to(dev)
        with HeldAgainstPlain() as held:
            inds = sampling.furthest_point_sample(xyz, 1024)
            new_xyz = sampling.gather_points(xyz, inds)
            idx = grouping.ball_query(xyz, new_xyz, 0.2, 64)
            grouping.group_points(table, idx)
        torch.cuda.synchronize(dev)
        attributes = card_attributes(dev)
        if torch.cuda.current_device() != 0:
            raise RuntimeError("the launches moved the current card")
        rows.append(dict(card=i, held=held.counts(), attributes=attributes))
    return rows


# ------------------------------------------------------------- the ranks
def _flagship_on(mesh, cfg, V, host, weights, hold: bool) -> Dict:
    from scan2cap_torch.data.synthetic import to_device
    from scan2cap_torch.kernels import launch_counts, reset_launch_counts
    from scan2cap_torch.parallel import mesh as pmesh
    from scan2cap_torch.probes.held import HeldAgainstPlain
    from scan2cap_torch.train.step import create_train_state, make_train_step

    model = build_capnet(cfg, V, mesh.device, weights)
    pmesh.shard_model(model)
    batch = to_device(host, mesh.device)
    mark = counted()
    out = pmesh.mesh_eval_fn(eval_forward(model))(batch)
    _sync(mesh.device)
    eval_coll = since(mark)
    state = create_train_state(cfg, model)
    step = make_train_step(cfg, state, **LOSSES)
    local = pmesh.local_rows(batch)
    reset_launch_counts()
    held = HeldAgainstPlain() if hold else contextlib.nullcontext()
    mark = counted()
    with held:
        metrics = step(local, LR, BN_MOMENTUM)
    loss = float(metrics["loss"])
    step_coll = since(mark)
    res = dict(shape=[mesh.n_data, mesh.n_model], rank=mesh.rank,
               device=str(mesh.device),
               launches={k: v for k, v in launch_counts().items() if v},
               held=held.counts() if hold else None,
               eval_collectives=eval_coll, step_collectives=step_coll,
               loss=loss, shards={n: list(p.shape) for n, p in
                                  model.named_parameters()
                                  if n in model.shard_dims})
    norms = grad_norms(model)
    if mesh.is_main:
        res.update({k: v.cpu() for k, v in out.items()}, norms=norms)
    return res


def _spatial_on(mesh, cfg, pc, weights, axis_calls: bool) -> Dict:
    """The backbone with the query axis over the model axis on this mesh's
    share of the scenes; with ``axis_calls`` also FPS's collectives alone."""
    from scan2cap_torch.ops.sampling import furthest_point_sample
    from scan2cap_torch.parallel import mesh as pmesh
    net = build_backbone(cfg, mesh.device, weights, spatial_axis="model")
    local = pmesh.local_rows(
        {"point_clouds": torch.from_numpy(pc).to(mesh.device)})
    res = dict(shape=[mesh.n_data, mesh.n_model], rank=mesh.rank,
               d=mesh.d)
    with torch.no_grad():
        if axis_calls:
            mark = counted()
            furthest_point_sample(local["point_clouds"][..., :3],
                                  cfg.sa_npoints[0])
            _sync(mesh.device)
            res["fps_collectives"] = since(mark)
        mark = counted()
        out = net(local, train=False)
        _sync(mesh.device)
    res["collectives"] = since(mark)
    if mesh.m == 0:
        res.update({k: out[k].cpu()
                    for k in SPATIAL_KEYS + ("fp2_features",)})
    return res


def _timing_on(mesh, cfg, V, hosts: Dict[int, Dict], traces: str) -> List:
    from scan2cap_torch.data.synthetic import to_device
    from scan2cap_torch.parallel import mesh as pmesh
    from scan2cap_torch.train.step import create_train_state, make_train_step
    from scan2cap_torch.utils import profiling

    model = build_capnet(cfg, V, mesh.device)
    pmesh.shard_model(model)
    step = make_train_step(cfg, create_train_state(cfg, model), **LOSSES)
    rows = []
    for B in sorted({TIMING_BATCH, TIMING_BATCH * mesh.n_data}):
        local = pmesh.local_rows(to_device(hosts[B], mesh.device))
        for _ in range(TIMING_WARMUP):
            float(step(local, LR, BN_MOMENTUM)["loss"])
        times = []
        for _ in range(TIMING_STEPS):
            t0 = time.perf_counter()
            float(step(local, LR, BN_MOMENTUM)["loss"])
            times.append((time.perf_counter() - t0) * 1e3)
        logdir = os.path.join(traces, f"{mesh.n_data}x{mesh.n_model}_b{B}_"
                                      f"r{mesh.rank}")
        prof = profiling.start(mesh.device)
        mark = counted()
        float(step(local, LR, BN_MOMENTUM)["loss"])
        coll = since(mark)
        profiling.stop(prof, logdir)
        rows.append(dict(shape=[mesh.n_data, mesh.n_model], rank=mesh.rank,
                         global_batch=B, ms=sorted(times)[len(times) // 2],
                         ms_all=times, collectives=coll,
                         **trace_nccl(os.path.join(logdir, "trace.json"))))
    del model, step
    release()
    return rows


def trace_nccl(path: str) -> Dict:
    """From a Chrome trace: the kernels' ms and count, NCCL's among them
    (kernels named ``nccl...``)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    nccl = [e for e in kernels if "nccl" in e["name"].lower()]
    return dict(kernel_ms=sum(e["dur"] for e in kernels) / 1e3,
                kernels=len(kernels),
                nccl_ms=sum(e["dur"] for e in nccl) / 1e3,
                nccl_kernels=len(nccl))


def _ranks(plan: Dict) -> List:
    """Every stage of ``plan`` on this rank; every rank's results, in rank
    order, on every rank."""
    from scan2cap_torch.parallel import mesh as pmesh
    from scan2cap_torch.parallel.mesh import MeshSpec

    world = pmesh.current()
    cuda = world.device.type == "cuda"
    res = dict(flagship=[], spatial=None, dp_spatial=None, timing=[])
    cfg, tiny = plan["cfg"], plan["tiny"]
    # every rank makes the inputs from their seeds
    host = flagship_batch(cfg, plan["batch"], tiny)
    for shape in plan["flagship_shapes"]:
        with pmesh.using(pmesh.sub_mesh(MeshSpec(*shape))) as mesh:
            res["flagship"].append(_flagship_on(
                mesh, cfg, plan["V"], host, plan["weights"], cuda))
        release()
    del host
    bb, pc = plan["backbone_weights"], spatial_inputs(cfg, tiny)
    with pmesh.using(pmesh.sub_mesh(MeshSpec(1, world.spec.size))) as mesh:
        res["spatial"] = _spatial_on(mesh, cfg, pc, bb, True)
    if plan["dp_shape"] is not None:
        with pmesh.using(pmesh.sub_mesh(MeshSpec(*plan["dp_shape"]))) as mesh:
            res["dp_spatial"] = _spatial_on(mesh, cfg, pc, bb, False)
    del pc
    release()
    if plan["timing"]:
        hosts = {}
        for shape in plan["timing_shapes"]:
            mesh = pmesh.sub_mesh(MeshSpec(*shape))
            if mesh is not None:
                for B in {TIMING_BATCH, TIMING_BATCH * shape[0]}:
                    if B not in hosts:
                        hosts[B] = flagship_batch(cfg, B, tiny)
                with pmesh.using(mesh):
                    res["timing"] += _timing_on(mesh, cfg, plan["V"], hosts,
                                                plan["traces"])
            pmesh.barrier()
    return pmesh.every_rank(res)


# ------------------------------------------------------------- the gates
def _differing(got: torch.Tensor, want: torch.Tensor) -> int:
    return int((got != want).sum())


def flagship_gates(ref: Dict, ranks: List[Dict], cuda: bool) -> Dict:
    """One mesh's results against one card's: the report and the failed
    gates."""
    main = ranks[0]
    failed = []
    got, want = main["lang_cap"], ref["lang_cap"]
    same = got == want
    agree = float(same.float().mean())
    diffs = [dict(scene=int(b), proposal=int(k), position=int(t),
                  got=int(got[b, k, t]), want=int(want[b, k, t]))
             for b, k, t in torch.nonzero(~same).tolist()[:LISTED]]
    if agree < TOKEN_AGREE:
        failed.append(f"eval tokens {agree:.4f} equal, below "
                      f"{TOKEN_AGREE}")
    corner = float((main["bbox_corner"] - ref["bbox_corner"]).abs().max())
    if corner > CORNER_TOL:
        failed.append(f"corners {corner} apart, above {CORNER_TOL}")
    picks = {k: _differing(main[k], ref[k]) for k in STAGES if k in ref}
    if picks["sa1_inds"]:
        failed.append(f"sa1 indices: {picks['sa1_inds']} differ")
    loss_rel = abs(main["loss"] - ref["loss"]) / abs(ref["loss"])
    if loss_rel > LOSS_REL:
        failed.append(f"train loss {main['loss']} against one card's "
                      f"{ref['loss']} (rel {loss_rel:.2e})")
    total = math.sqrt(sum(v * v for v in ref["norms"].values()))
    worst, worst_rel = None, 0.0
    for name, v in ref["norms"].items():
        rel = abs(main["norms"][name] - v) / max(v, 1e-6 * total)
        if rel > worst_rel:
            worst, worst_rel = name, rel
    if worst_rel > NORM_REL:
        failed.append(f"gradient norm of {worst}: {main['norms'][worst]} "
                      f"against one card's {ref['norms'][worst]}")
    if cuda:
        want_launches = dict(furthest_point_sample_cuda=5,
                             ball_query_cuda=5, group_points_cuda=6)
        for r in ranks:
            got_l = {k: r["launches"].get(k, 0) for k in want_launches}
            if got_l != want_launches or r["held"] != want_launches:
                failed.append(f"rank {r['rank']}: launches {got_l}, held "
                              f"{r['held']}; want {want_launches}")
    return dict(
        shape=main["shape"], batch=int(want.shape[0]),
        tokens_equal=agree, tokens=int(same.numel()),
        tokens_differing=int((~same).sum()), differing_tokens=diffs,
        corner_max_abs_diff=corner, differing_picks=picks,
        loss=main["loss"], loss_one_card=ref["loss"], loss_rel_diff=loss_rel,
        worst_norm=worst, worst_norm_rel_diff=worst_rel,
        launches_per_rank=[r["launches"] for r in ranks],
        held_per_rank=[r["held"] for r in ranks],
        devices=[r["device"] for r in ranks],
        shards=main["shards"],
        eval_collectives=[r["eval_collectives"] for r in ranks],
        step_collectives=[r["step_collectives"] for r in ranks],
        failed=failed)


def spatial_gates(ref: Dict, ranks: List[Dict], dp: bool,
                  table_bytes: Optional[int] = None) -> Dict:
    """The (1, N) or the dp (2, N/2) backbone against the unsharded one.
    ``table_bytes`` (one scene table) bounds the bytes a dp rank receives,
    as the JAX stage bounds them at the flagship's widths; at the tiny
    widths the projections outweigh the few input columns, and no bound
    is passed."""
    failed = []
    picks, feature = {}, 0.0
    scale = float(ref["fp2_features"].abs().max())
    for r in ranks:
        if "fp2_features" not in r:
            continue
        rows = slice(r["d"], r["d"] + 1) if dp else slice(None)
        for k in SPATIAL_KEYS:
            picks[k] = picks.get(k, 0) + _differing(r[k], ref[k][rows])
        feature = max(feature, float(
            (r["fp2_features"] - ref["fp2_features"][rows]).abs().max()))
    for k, n in picks.items():
        if n:
            failed.append(f"{k}: {n} picks differ from the unsharded "
                          f"backbone's")
    if feature > FEATURE_REL * max(scale, 1.0):
        failed.append(f"fp2 features {feature} apart (scale {scale}), above "
                      f"{FEATURE_REL} of it")
    coll = [r["collectives"] for r in ranks]
    out = dict(shape=ranks[0]["shape"], differing_picks=picks,
               fp2_max_abs_diff=feature, fp2_scale=scale,
               collectives=coll, failed=failed)
    if dp:
        data = [c["data"]["calls"] for c in coll]
        received = max(sum(a["bytes"] for a in c.values()) for c in coll)
        if any(data):
            failed.append(f"data-axis collectives {data} in the dp_spatial "
                          f"forward")
        if table_bytes is not None and received >= table_bytes:
            failed.append(f"{received} bytes received, one scene table is "
                          f"{table_bytes}")
        out["bytes_received_max"] = received
    else:
        fps = [sum(a["calls"] for a in r["fps_collectives"].values())
               for r in ranks]
        if any(fps):
            failed.append(f"FPS issued collectives {fps}")
        out["fps_collectives"] = fps
    return out


# ------------------------------------------------------------- the run
def run(n: int, device: str = "cuda", weights: Optional[Dict] = None,
        timing: bool = True) -> Dict:
    """The dryrun over ``n`` ranks on ``device`` ("cpu": gloo ranks at the
    tiny size; their times are the host's).  ``weights`` may give the
    CapNet's (``"capnet"``) and the backbone's (``"backbone"``) state dicts
    in place of the seeded ones; ``timing`` runs the timing stage.
    Returns the report: ``report["failed"]`` lists the failed gates,
    ``report["outputs"]`` holds the one-card references and every rank's
    results (tensors)."""
    from scan2cap_torch.parallel import mesh as pmesh

    weights = weights or {}
    cuda = torch.device(device).type == "cuda"
    if n > pmesh.device_count(device):
        raise SystemExit(f"--cards {n}: only {pmesh.device_count(device)} "
                         f"{'CUDA devices' if cuda else 'CPU ranks'} "
                         f"available")
    tiny = not cuda
    cfg = flagship_cfg(tiny)
    V = TINY_VOCABS if tiny else NUM_VOCABS
    B = batch_size(n, tiny)
    host = flagship_batch(cfg, B, tiny)
    pc = spatial_inputs(cfg, tiny)
    ref_device = "cuda:0" if cuda else "cpu"
    report = dict(cards=n, device=device, tiny=tiny, batch=B,
                  num_points=cfg.num_points,
                  num_proposals=cfg.num_proposals, num_vocabs=V,
                  spatial=dict(batch=SPATIAL_B, num_points=pc.shape[1]))
    if cuda:
        report.update(card=torch.cuda.get_device_name(0),
                      nccl=".".join(map(str, torch.cuda.nccl.version())),
                      torch=torch.__version__)
    t0 = time.perf_counter()
    ref = flagship_reference(cfg, V, host, ref_device,
                             weights.get("capnet"))
    spatial_ref = spatial_reference(cfg, pc, ref_device,
                                    weights.get("backbone"))
    if cuda:
        report["other_cards"] = other_cards(n)
    release()
    report["reference_s"] = time.perf_counter() - t0
    dp_shape = (2, n // 2) if n >= 2 and n % 2 == 0 else None
    with tempfile.TemporaryDirectory(prefix="scan2cap_dryrun_") as tmp:
        plan = dict(cfg=cfg, tiny=tiny, V=V, batch=B,
                    weights=weights.get("capnet"),
                    backbone_weights=weights.get("backbone"),
                    flagship_shapes=mesh_shapes(n), dp_shape=dp_shape,
                    timing=timing,
                    timing_shapes=[s for s in TIMING_SHAPES
                                   if s[0] * s[1] <= n],
                    traces=tmp)
        t0 = time.perf_counter()
        per_rank = pmesh.launch(pmesh.MeshSpec(n, 1), device, _ranks, plan)
        report["ranks_s"] = time.perf_counter() - t0
    flagship = []
    for i, shape in enumerate(plan["flagship_shapes"]):
        flagship.append(flagship_gates(
            ref, [r["flagship"][i] for r in per_rank], cuda))
    report["flagship"] = flagship
    table = SPATIAL_B * pc.shape[1] * pc.shape[2] * 4
    report["spatial"].update(spatial_gates(
        spatial_ref, [r["spatial"] for r in per_rank], False),
        scene_table_bytes=table)
    report["dp_spatial"] = (
        spatial_gates(spatial_ref, [r["dp_spatial"] for r in per_rank],
                      True, None if tiny else table)
        if dp_shape else dict(ran=False, reason="needs two data ranks"))
    report["timing"] = [row for r in per_rank for row in r["timing"]]
    report["outputs"] = dict(reference=ref, spatial_reference=spatial_ref,
                             ranks=per_rank)
    report["failed"] = [f"{stage} {r['shape']}: {msg}"
                        for stage, rows in (("flagship", flagship),
                                            ("spatial", [report["spatial"]]),
                                            ("dp_spatial",
                                             [report["dp_spatial"]]))
                        for r in rows for msg in r.get("failed", [])]
    return report


def summary(report: Dict) -> List[str]:
    """The report's lines for a reader."""
    lines = []
    for f in report["flagship"]:
        step = f["step_collectives"][0]
        lines.append(
            f"flagship {f['shape']}: B={f['batch']} tokens "
            f"{f['tokens_equal']:.4f} equal ({f['tokens_differing']} of "
            f"{f['tokens']} differ), corners {f['corner_max_abs_diff']:.2e}, "
            f"picks differing {f['differing_picks']}, loss rel "
            f"{f['loss_rel_diff']:.2e}, worst norm "
            f"{f['worst_norm_rel_diff']:.2e}; rank 0's step collectives "
            + ", ".join(f"{a} {c['calls']} calls {c['bytes']} B"
                        for a, c in step.items() if c["calls"]))
    s = report["spatial"]
    lines.append(f"spatial {s['shape']}: N={s['num_points']} picks "
                 f"differing {s['differing_picks']}, fp2 "
                 f"{s['fp2_max_abs_diff']:.2e} (scale {s['fp2_scale']:.2f}), "
                 f"FPS collectives {s['fps_collectives']}")
    d = report["dp_spatial"]
    if d.get("ran", True):
        lines.append(f"dp_spatial {d['shape']}: picks differing "
                     f"{d['differing_picks']}, at most "
                     f"{d['bytes_received_max']} bytes received (one scene "
                     f"table {report['spatial']['scene_table_bytes']})")
    cells = {}
    for t in report["timing"]:
        cells.setdefault((tuple(t["shape"]), t["global_batch"]), []).append(t)
    for (shape, B), rows in cells.items():
        lines.append(f"timing {list(shape)} B={B}: ms a step by rank "
                     f"{[round(t['ms'], 1) for t in rows]}, NCCL kernel ms "
                     f"{[round(t['nccl_ms'], 2) for t in rows]}")
    for r in report.get("other_cards", ()):
        lines.append(f"card {r['card']} from this process after card 0: "
                     f"held {r['held']}, attribute tiers and probes held "
                     f"{r['attributes']}")
    lines.extend(f"FAILED: {msg}" for msg in report["failed"])
    return lines


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, required=True,
                    help="ranks: CUDA devices, or gloo ranks on the CPU")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--json", default=None, help="also write the report")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("dryrun_multicard: CUDA is not available (pass "
                         "--device cpu for gloo ranks)")
    report = run(args.cards, args.device)
    del report["outputs"]
    for line in summary(report):
        print(line, flush=True)
    text = json.dumps(report)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            f.write(text)
    print(text)
    return 1 if report["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
