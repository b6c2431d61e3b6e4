"""Training demo on synthetic scenes:
``python -m scan2cap_torch.scripts.demo_synthetic_train`` (counterpart of
``scripts/demo_synthetic_train.py``).

Trains the detector (backbone, voting, proposal and the detection losses)
on a few synthetic batches made once and cycled, prints the vote,
objectness and box losses as they fall, and scores mAP@0.25 on a held-out
batch: the milestone check passes when the loss fell and mAP is above 0.
``--caption`` trains the whole CapNet.  ``--bf16`` narrows the backbone's
MLP chain to bfloat16 compute, ``--bf16_storage`` only its inter-layer
activations, both in the modules ``--bf16_components`` names.  ``--mesh
DATA,MODEL`` trains over DATA x MODEL ranks (``parallel.mesh``), each on
its rows of every batch; rank 0 prints.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

NUM_VOCABS = 128


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=150)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--num_points", type=int, default=40000)
    p.add_argument("--num_batches", type=int, default=4,
                   help="distinct synthetic batches cycled during training")
    p.add_argument("--caption", action="store_true")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 backbone MLP chain (geometry stays f32)")
    p.add_argument("--bf16_components", type=str,
                   default="sa1,sa2,sa3,sa4,fp",
                   help="with --bf16 or --bf16_storage: which backbone "
                        "modules narrow")
    p.add_argument("--bf16_storage", action="store_true",
                   help="storage-only bfloat16: layer-boundary activation "
                        "buffers half-width, all matmul/BN compute f32 "
                        "(subsumed by --bf16)")
    p.add_argument("--mesh", type=str, default=None, metavar="DATA,MODEL",
                   help="train over DATA x MODEL ranks (scenes over DATA)")
    p.add_argument("--use_normal", action="store_true")
    p.add_argument("--use_multiview", action="store_true")
    p.add_argument("--use_pretrained", type=str, default=None,
                   help="warm-start the detection modules from a "
                        "reference-layout VoteNet .pth")
    p.add_argument("--device", type=str, default="cuda",
                   help="the device to run on (cuda, or cpu)")
    return p


def main(argv=None) -> int:
    from scan2cap_torch.scripts import demo_synthetic_train as this
    from scan2cap_torch.scripts.train import on_mesh
    args = build_parser().parse_args(argv)
    if args.mesh:
        return on_mesh(args, this.run, args.batch_size)
    return run(args)


def run(args) -> int:
    import torch

    from scan2cap_torch.config import ModelConfig
    from scan2cap_torch.convert import mount_detection_weights
    from scan2cap_torch.data.synthetic import (make_scene_batch, make_vocab,
                                               to_device)
    from scan2cap_torch.device import resolve_device
    from scan2cap_torch.models import CapNet
    from scan2cap_torch.parallel import mesh as pmesh
    from scan2cap_torch.scripts.quality_trajectory import eval_detection
    from scan2cap_torch.scripts.train import mesh_line
    from scan2cap_torch.train.step import (create_train_state,
                                           make_eval_step, make_train_step)

    mesh = pmesh.current()
    device = mesh.device if mesh is not None else resolve_device(args.device)
    say = print if pmesh.is_main() else (lambda *a, **k: None)
    if mesh is not None:
        say(mesh_line(mesh), flush=True)
    cfg = ModelConfig(num_points=args.num_points, no_caption=not args.caption,
                      min_iou=-1.0, use_normal=args.use_normal,
                      use_multiview=args.use_multiview,
                      compute_dtype="bfloat16" if args.bf16 else "float32",
                      storage_dtype=("bfloat16" if args.bf16_storage
                                     else "float32"),
                      bf16_components=args.bf16_components)
    # test hook (as scripts/train.py's): a small SA pyramid and few proposals
    if os.environ.get("SCAN2CAP_TEST_TINY"):
        cfg = dataclasses.replace(cfg, sa_npoints=(128, 64, 32, 16),
                                  num_proposals=16, max_num_obj=16)
    vocab = make_vocab(num_vocabs=NUM_VOCABS, emb_size=cfg.emb_size)

    say("building synthetic batches...", flush=True)
    hosts = [make_scene_batch(cfg, batch_size=args.batch_size, num_objects=6,
                              vocab=vocab, seed=s)
             for s in range(args.num_batches + 1)]
    batches = [to_device(h, device) for h in hosts]
    # a rank of a mesh trains on its rows; the eval takes whole batches
    train_batches = [pmesh.local_rows(b) for b in batches]

    model = CapNet(cfg, num_vocabs=NUM_VOCABS, device=device, seed=args.seed)
    if args.use_pretrained:
        mount_detection_weights(model, args.use_pretrained)
        say(f"warm-started detection modules from {args.use_pretrained}",
            flush=True)
    if mesh is not None:
        pmesh.shard_model(model)
    state = create_train_state(cfg, model)
    step = make_train_step(cfg, state, detection=True, caption=args.caption)

    losses = []
    t_start = time.perf_counter()
    first = {}
    metrics = {}
    for i in range(args.steps):
        metrics = step(train_batches[i % args.num_batches], args.lr, 0.1)
        if i == 0:
            first = {k: float(v) for k, v in metrics.items()}
            say(f"[step 0] first step {time.perf_counter() - t_start:.1f}s",
                  flush=True)
            t_start = time.perf_counter()   # the first step is not timed
        if i % 25 == 0 or i == args.steps - 1:
            row = {k: float(metrics[k]) for k in
                   ("loss", "vote_loss", "objectness_loss", "box_loss",
                    "obj_acc")}
            losses.append(dict(step=i, **row))
            say(f"[step {i}] loss {row['loss']:.3f} "
                  f"vote {row['vote_loss']:.3f} "
                  f"obj {row['objectness_loss']:.3f} "
                  f"box {row['box_loss']:.3f} "
                  f"obj_acc {row['obj_acc']:.3f}", flush=True)
    float(metrics["loss"])                  # the steps have ended
    steps_per_sec = (args.steps - 1) / (time.perf_counter() - t_start)
    say(f"train throughput ~{steps_per_sec * args.batch_size:.2f} "
        f"scenes/s ({steps_per_sec:.2f} steps/s)", flush=True)

    # held-out synthetic batch -> detection mAP
    eval_step = make_eval_step(cfg, model)
    if mesh is not None:
        eval_step = pmesh.mesh_eval_fn(eval_step)
    m25, ar = eval_detection(eval_step, [(batches[-1], hosts[-1])])
    last = {k: float(v) for k, v in metrics.items()}
    say(f"final: loss {first['loss']:.2f} -> {last['loss']:.2f}; "
        f"mAP@0.25 = {m25:.4f}, AR = {ar:.4f}")
    say(json.dumps({"demo": {
        "steps": args.steps, "batch_size": args.batch_size,
        "num_points": args.num_points, "caption": args.caption,
        "compute_dtype": cfg.compute_dtype,
        "storage_dtype": cfg.storage_dtype,
        "bf16_components": cfg.bf16_components,
        "first": first, "last": last, "logged": losses, "map25": m25,
        "ar25": ar, "scenes_per_sec": steps_per_sec * args.batch_size,
        "platform": device.type, "torch": torch.__version__,
        "mesh": args.mesh}}), flush=True)
    if not last["loss"] < first["loss"]:
        raise SystemExit("loss did not decrease")
    if not m25 > 0:
        raise SystemExit("mAP is zero")
    say("milestone check passed", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
