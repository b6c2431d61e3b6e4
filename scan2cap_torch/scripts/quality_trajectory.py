"""The flagship's training-quality trajectory:
``python -m scan2cap_torch.scripts.quality_trajectory`` (counterpart of
``scripts/quality_trajectory.py``).

Trains the flagship CapNet (multiview + normal + height channels, zeros
beyond xyz and height for synthetic scenes; top-down decoder, 2 graph steps
over 10 locals, relation and orientation heads; 256 proposals over 40,000
points) on synthetic scenes at a constant learning rate and BN momentum 0.1,
and records every ``--eval_every`` steps:

  * detection mAP@0.25 and AR over ``--eval_batches`` held-out batches, in
    one ``APCalculator`` (``eval_detection``);
  * CIDEr of the free-running decode on the training scenes, the caption
    of each reference object taken from its best kept proposal past IoU
    0.25 (``eval_cider``);
  * the step's loss, caption loss and caption accuracy.

The batches are made once with ``data.synthetic.make_scene_batch`` (equal
to the JAX package's for equal seeds) and staged on the device once.  The
weights are the port's own seeded draw (``models.layers.seeded_init``), so
a curve is not the JAX package's point for point; its bounds are
``tests/test_quality_trajectory.py``'s.

The JSON line has the JAX script's keys plus ``card`` (nvidia-smi's name
and power limit), ``torch``, the seconds spent in training steps and in
each evaluation, the kernels' launches per training step, and the
backbone's ``storage_dtype`` under ``config``.  ``--bf16_storage`` stores
the backbone MLPs' inter-layer activations in bfloat16 (every product and
BN stays float32).  ``--mesh DATA,MODEL`` trains over DATA x MODEL ranks
(``parallel.mesh``), each on its rows of every batch; the evaluations take
whole batches, and rank 0 prints and writes.

Run on the card (the committed curve's settings):
    python -m scan2cap_torch.scripts.quality_trajectory --eval_batches 4 \\
        --out scan2cap_torch/measurements/quality_trajectory_h100.json
On the CPU at the slow-test size: add ``--tiny --device cpu``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

NUM_VOCABS = 128
# the caption gate of the trajectory (the JAX script's choice: at 0.5 a few
# borderline boxes crossing the gate make the curve useless as a signal)
CIDER_MIN_IOU = 0.25


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=600)
    p.add_argument("--eval_every", type=int, default=50)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--num_batches", type=int, default=4,
                   help="distinct synthetic batches cycled during training")
    p.add_argument("--eval_batches", type=int, default=1,
                   help="held-out batches for the detection eval")
    p.add_argument("--num_points", type=int, default=40000)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--seeds", type=str, default="",
                   help="comma-separated seeds, run in one process; --out "
                        "must contain '{seed}'")
    p.add_argument("--out", type=str, default="")
    p.add_argument("--tiny", action="store_true",
                   help="the CPU-sized config of the slow test")
    p.add_argument("--bf16_storage", action="store_true",
                   help="storage-only bfloat16 backbone buffers")
    p.add_argument("--mesh", type=str, default=None, metavar="DATA,MODEL",
                   help="train over DATA x MODEL ranks (scenes over DATA, "
                        "the caption classifier and attention over MODEL)")
    p.add_argument("--device", type=str, default="cuda",
                   help="the device to run on (cuda, or cpu)")
    return p


def parse_args(argv=None):
    p = build_parser()
    args = p.parse_args(argv)
    if args.seeds and len(args.seeds.split(",")) > 1:
        if not (args.out and "{seed}" in args.out):
            p.error("--seeds needs --out with a '{seed}' placeholder")
    return args


def make_config(args):
    from scan2cap_torch.config import ModelConfig
    storage = "bfloat16" if args.bf16_storage else "float32"
    if args.tiny:
        return ModelConfig(
            num_points=min(args.num_points, 1024), num_proposals=32,
            sa_npoints=(256, 128, 64, 32), max_num_obj=8, num_locals=4,
            num_graph_steps=2, use_topdown=True, use_relation=True,
            use_orientation=True, min_iou=-1.0, storage_dtype=storage)
    return ModelConfig(
        num_points=args.num_points, num_graph_steps=2, num_locals=10,
        use_topdown=True, use_relation=True, use_orientation=True,
        use_normal=True, use_multiview=True, min_iou=-1.0,
        storage_dtype=storage)


Pair = Tuple[Dict[str, torch.Tensor], Dict[str, np.ndarray]]


def eval_detection(eval_step, pairs: Sequence[Pair]) -> Tuple[float, float]:
    """mAP@0.25 and AR over all held-out (device batch, host batch) pairs
    in one ``APCalculator``."""
    from scan2cap_torch.eval.ap_helper import (
        APCalculator, assemble_pred_map_cls, parse_groundtruths,
        parse_predictions_device)
    calc = APCalculator(0.25)
    for batch, host in pairs:
        out = eval_step(batch)
        parsed = parse_predictions_device(
            {**out, "point_clouds": batch["point_clouds"]})
        parsed = {k: v.cpu().numpy() for k, v in parsed.items()}
        preds = assemble_pred_map_cls(out["bbox_corner"].cpu().numpy(),
                                      parsed)
        calc.step(preds, parse_groundtruths(host))
    m = calc.compute_metrics()
    return float(m["mAP"]), float(m["AR"])


def eval_cider(eval_step, pairs: Sequence[Pair], idx2word: Dict) -> float:
    """CIDEr of the free-running decode on the training scenes, scored over
    all pairs at once: each scene's reference object gets the caption of
    its kept proposal of highest IoU (gate ``CIDER_MIN_IOU``), else
    "sos eos"."""
    from scan2cap_torch.eval.capeval import Cider
    from scan2cap_torch.eval.eval_helper import (decode_caption,
                                                 postprocess_scene_cap)
    corpus, cands = {}, {}
    for bi, (batch, host) in enumerate(pairs):
        post = postprocess_scene_cap(eval_step(batch), batch,
                                     min_iou=CIDER_MIN_IOU)
        keep = post["keep"].cpu().numpy()
        det = post["detected_object_ids"].cpu().numpy()
        ious = post["ious"].cpu().numpy()
        caps = post["captions"].cpu().numpy()
        for b in range(keep.shape[0]):
            oid = int(host["object_id"][b])
            key = f"batch{bi}|scene{b}|{oid}"
            corpus[key] = [decode_caption(host["lang_ids"][b], idx2word)]
            cand, best = "sos eos", -1.0
            for k in np.where(keep[b])[0]:
                if int(det[b, k]) == oid and ious[b, k] > best:
                    best = float(ious[b, k])
                    cand = decode_caption(caps[b, k], idx2word)
            cands[key] = [cand]
    return float(Cider().compute_score(corpus, cands)[0])


def card_line(device: torch.device) -> str:
    """nvidia-smi's name and power limit of the card, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def _delta(after: Dict[str, int], before: Dict[str, int]) -> Dict[str, int]:
    return {k: after[k] - before.get(k, 0) for k in after}


def run_seed(args, cfg, seed: int, train_pairs: List[Pair],
             eval_pairs: List[Pair], idx2word: Dict,
             device: torch.device) -> Dict:
    from scan2cap_torch.kernels import launch_counts, reset_launch_counts
    from scan2cap_torch.models import CapNet
    from scan2cap_torch.parallel import mesh as pmesh
    from scan2cap_torch.train.step import (create_train_state,
                                           make_eval_step, make_train_step)

    mesh = pmesh.current()
    # the vocabulary splits over the model axis (128 divides it already)
    vocab_pad = (pmesh.padded_vocab(NUM_VOCABS, mesh.n_model)
                 if mesh is not None and mesh.n_model > 1 else 0)
    model = CapNet(cfg, num_vocabs=NUM_VOCABS, num_vocabs_padded=vocab_pad,
                   device=device, seed=seed)
    if mesh is not None:
        pmesh.shard_model(model)
    state = create_train_state(cfg, model)
    step = make_train_step(cfg, state, detection=True, caption=True,
                           orientation=True)
    eval_step = make_eval_step(cfg, model)
    if mesh is not None:
        eval_step = pmesh.mesh_eval_fn(eval_step)
    # a rank of a mesh trains on its rows; the evaluations take whole
    # batches
    train_batches = [pmesh.local_rows(b) for b, _ in train_pairs]
    curve = {"step": [], "loss": [], "cap_loss": [], "cap_acc": [],
             "map25": [], "ar25": [], "cider_train": []}
    eval_s: List[float] = []

    def record(step_i, metrics):
        t0 = time.perf_counter()
        m25, ar = eval_detection(eval_step, eval_pairs)
        cid = eval_cider(eval_step, train_pairs, idx2word)
        eval_s.append(time.perf_counter() - t0)
        curve["step"].append(step_i)
        for key in ("loss", "cap_loss", "cap_acc"):
            curve[key].append(round(float(metrics[key]), 4) if metrics
                              else None)
        curve["map25"].append(round(m25, 4))
        curve["ar25"].append(round(ar, 4))
        curve["cider_train"].append(round(cid, 4))
        if pmesh.is_main():
            print(f"seed {seed} step {step_i:4d}: loss {curve['loss'][-1]} "
              f"mAP@0.25 {m25:.4f} AR {ar:.4f} CIDEr(train) {cid:.4f}",
              flush=True)

    reset_launch_counts()
    record(0, None)
    eval_launches = launch_counts()
    lr, mom = args.lr, 0.1
    metrics = None
    step_s = 0.0
    t_train = time.perf_counter()
    for i in range(1, args.steps + 1):
        t0 = time.perf_counter()
        metrics = step(train_batches[(i - 1) % args.num_batches], lr, mom)
        if i % args.eval_every == 0 or i == args.steps:
            float(metrics["loss"])          # the steps have ended
            step_s += time.perf_counter() - t0
            before = launch_counts()
            record(i, metrics)
            eval_launches = {k: v + eval_launches[k] for k, v in
                             _delta(launch_counts(), before).items()}
        else:
            step_s += time.perf_counter() - t0
    wall = time.perf_counter() - t_train
    train_launches = _delta(launch_counts(), eval_launches)

    return {
        "config": {"tiny": args.tiny, "num_points": cfg.num_points,
                   "num_proposals": cfg.num_proposals,
                   "batch_size": args.batch_size, "steps": args.steps,
                   "num_batches": args.num_batches,
                   "eval_batches": args.eval_batches, "lr": args.lr,
                   "seed": seed, "mesh": args.mesh,
                   "flagship": not args.tiny,
                   "storage_dtype": cfg.storage_dtype},
        "platform": device.type,
        "curve": curve,
        "final": {"map25": curve["map25"][-1], "ar25": curve["ar25"][-1],
                  "cider_train": curve["cider_train"][-1],
                  "loss": curve["loss"][-1]},
        "train_wall_s": round(wall, 1),
        "train_scenes_per_sec": round(args.steps * args.batch_size / wall, 2),
        # the steps alone (the wall above includes the evaluations)
        "step_s": round(step_s, 3),
        "ms_per_step": round(step_s / args.steps * 1e3, 2),
        "step_scenes_per_sec": round(args.steps * args.batch_size / step_s,
                                     2),
        "eval_s_per_record": [round(s, 3) for s in eval_s],
        "launches_per_step": {k: v / args.steps
                              for k, v in train_launches.items() if v},
        "eval_launches": {k: v for k, v in eval_launches.items() if v},
    }


def main(argv=None) -> int:
    from scan2cap_torch.scripts import quality_trajectory as this
    from scan2cap_torch.scripts.train import on_mesh
    args = parse_args(argv)
    if args.mesh:
        return on_mesh(args, this.run, args.batch_size)
    return run(args)


def run(args) -> int:
    from scan2cap_torch.data.synthetic import (make_scene_batch, make_vocab,
                                               to_device)
    from scan2cap_torch.device import resolve_device
    from scan2cap_torch.parallel import mesh as pmesh
    from scan2cap_torch.scripts.train import mesh_line

    mesh = pmesh.current()
    main = pmesh.is_main()
    device = mesh.device if mesh is not None else resolve_device(args.device)
    if mesh is not None and main:
        print(mesh_line(mesh), flush=True)
    cfg = make_config(args)
    vocab = make_vocab(num_vocabs=NUM_VOCABS, emb_size=cfg.emb_size)
    if main:
        print(f"building {args.num_batches}+{args.eval_batches} synthetic "
              f"batches (N={cfg.num_points}, B={args.batch_size})...",
              flush=True)
    t0 = time.perf_counter()
    hosts = [make_scene_batch(cfg, batch_size=args.batch_size, num_objects=6,
                              vocab=vocab, seed=s)
             for s in range(args.num_batches + args.eval_batches)]
    pairs = [(to_device(h, device), h) for h in hosts]
    if main:
        print(f"staged in {time.perf_counter() - t0:.0f}s", flush=True)
    nb = args.num_batches
    card = card_line(device)

    seeds = ([int(s) for s in args.seeds.split(",") if s.strip()]
             if args.seeds else [args.seed])
    for seed in seeds:
        result = run_seed(args, cfg, seed, pairs[:nb], pairs[nb:],
                          vocab["idx2word"], device)
        result.update(card=card, torch=torch.__version__)
        if not main:
            continue
        line = json.dumps(result)
        print(line, flush=True)
        if args.out:
            with open(args.out.replace("{seed}", str(seed)), "w") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
