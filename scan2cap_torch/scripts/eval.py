"""Evaluation CLI of the port: ``python -m scan2cap_torch.scripts.eval``
(counterpart of ``scripts/eval.py``).

Evaluates a port run folder under ``SCAN2CAP_OUTPUT``: the caption metrics
(CIDEr, BLEU, ROUGE-L, METEOR of the captions whose box passes ``--min_iou``)
and/or detection mAP and AR at 0.25 and 0.5.  The model is rebuilt from the
run's info.json; its weights come from the run's best (else last)
checkpoint, ``--use_last``'s last one, or ``--use_pretrained``: a port run
name, a full reference-layout ``model.pth`` (all of it), or a
detection-only ``.pth`` (detection eval only).  ``eval_stats.json`` in the
run folder keeps each pass's batches, seconds and kernel launches.
``--mesh DATA,MODEL`` evaluates over DATA x MODEL ranks (``parallel.mesh``):
scenes split over DATA (an uneven last batch padded), each caption decode's
targets over MODEL; rank 0 prints, scores and writes, and the scores are
the single process's.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from contextlib import contextmanager

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--folder", type=str, required=True,
                   help="run folder (under SCAN2CAP_OUTPUT) holding ckpt/ "
                        "and info.json")
    p.add_argument("--dataset", type=str, default="ScanRefer")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--min_iou", type=float, default=0.5)
    p.add_argument("--eval_caption", action="store_true")
    p.add_argument("--eval_detection", action="store_true")
    p.add_argument("--use_last", action="store_true",
                   help="evaluate the last checkpoint instead of the best")
    p.add_argument("--use_train", action="store_true",
                   help="evaluate on the train split")
    p.add_argument("--no_nms", action="store_true",
                   help="skip NMS in the caption eval's post-processing")
    p.add_argument("--use_pretrained", type=str, default=None,
                   help="a reference-layout .pth or a port run name in "
                        "place of the folder's checkpoint")
    p.add_argument("--force", action="store_true")
    p.add_argument("--mesh", type=str, default=None, metavar="DATA,MODEL",
                   help="evaluate over DATA x MODEL ranks: scenes over "
                        "DATA (uneven last batch padded), the caption "
                        "decode's targets over MODEL")
    p.add_argument("--save_interm", action="store_true",
                   help="dump per-object boxes, captions and attention to "
                        "interm.json")
    p.add_argument("--device", type=str, default="cuda",
                   help="the device to run on (cuda, or cpu)")
    return p


def load_weights(model, args, paths, folder, num_vocabs_padded):
    """Mount the weights ``args`` asks for into ``model``."""
    from scan2cap_torch.convert import (is_detection_only, load_reference,
                                        mount_detection_weights,
                                        state_dict_from_reference)
    from scan2cap_torch.train.checkpoints import CheckpointIO

    if args.use_pretrained and args.use_pretrained.endswith(".pth"):
        sd = load_reference(args.use_pretrained)      # read once
        if not is_detection_only(sd):
            model.load_state_dict(state_dict_from_reference(
                sd, num_vocabs_padded or None), strict=True)
        elif args.eval_caption:
            raise SystemExit(
                "--use_pretrained <.pth> holds detection weights only; "
                "combine it with --eval_detection, not --eval_caption")
        else:
            mount_detection_weights(model, sd)
        return
    src = (os.path.join(paths.output, args.use_pretrained, "ckpt")
           if args.use_pretrained else os.path.join(folder, "ckpt"))
    ckpt = CheckpointIO(src)
    bundle = (ckpt.restore("last") if args.use_last
              else ckpt.restore_best_or_last())
    model.load_state_dict(bundle["model"], strict=True)


@contextmanager
def counted(stats: dict, name: str, batches: int):
    """Time a pass over ``batches`` batches and count its kernel launches
    into ``stats[name]``."""
    from scan2cap_torch.kernels import launch_counts
    before, t0 = launch_counts(), time.perf_counter()
    yield
    stats[name] = dict(batches=batches, s=time.perf_counter() - t0,
                       launches={k: v - before[k]
                                 for k, v in launch_counts().items()})


def evaluate(args):
    import torch

    from scan2cap_torch.config import PathConfig
    from scan2cap_torch.data.dataset import (Loader, ScannetReferenceDataset,
                                             get_scanrefer)
    from scan2cap_torch.data.synthetic import to_device
    from scan2cap_torch.device import resolve_device
    from scan2cap_torch.eval.ap_helper import (APCalculator,
                                               assemble_pred_map_cls,
                                               parse_groundtruths,
                                               parse_predictions_device)
    from scan2cap_torch.eval.eval_helper import eval_cap, prepare_corpus
    from scan2cap_torch.models import CapNet
    from scan2cap_torch.parallel import mesh as pmesh
    from scan2cap_torch.scripts.train import (dataset_kwargs, mesh_line,
                                              model_config_from_info)
    from scan2cap_torch.train.step import make_eval_step

    mesh = pmesh.current()
    main = pmesh.is_main()
    device = mesh.device if mesh is not None else resolve_device(args.device)
    if mesh is not None and main:
        print(mesh_line(mesh), flush=True)
    paths = PathConfig()
    folder = os.path.join(paths.output, args.folder)
    with open(os.path.join(folder, "info.json")) as f:
        info = json.load(f)
    mcfg = model_config_from_info(info)

    train_path = os.path.join(paths.data, f"{args.dataset}_filtered_train.json")
    val_path = os.path.join(paths.data, f"{args.dataset}_filtered_val.json")
    scanrefer_train, eval_train, eval_val, all_scenes = get_scanrefer(
        train_path, val_path, info.get("num_scenes", -1))
    eval_list = eval_train if args.use_train else eval_val
    eval_split = "train" if args.use_train else "val"

    common = dataset_kwargs(paths, mcfg)
    train_ds = ScannetReferenceDataset(
        scanrefer_train, all_scenes, split="train", augment=False, **common)
    val_ds = ScannetReferenceDataset(
        eval_list, all_scenes, split=eval_split, augment=False,
        vocab=train_ds.vocabulary, glove=train_ds.glove, **common)
    val_loader = Loader(val_ds, args.batch_size, shuffle=False,
                        seed=args.seed, drop_last=False)

    vocab_pad = int(info.get("num_vocabs_padded", 0) or 0)
    model = CapNet(mcfg, num_vocabs=train_ds.num_vocabs,
                   num_vocabs_padded=vocab_pad, device=device,
                   seed=args.seed)
    load_weights(model, args, paths, folder, vocab_pad)
    if args.save_interm and not args.eval_caption:
        if main:
            print("WARNING: --save_interm only produces output with "
                  "--eval_caption; ignoring it")
        args.save_interm = False
    eval_step = make_eval_step(mcfg, model, keep_attn=args.save_interm)
    if mesh is not None:
        eval_step = pmesh.mesh_eval_fn(eval_step)
    results, stats = {}, {}

    if args.eval_caption:
        with open(os.path.join(paths.data,
                               "ScanRefer_filtered_organized.json")) as f:
            organized = json.load(f)
        split_path = train_path if args.use_train else val_path
        scenes = {e["scene_id"] for e in eval_list}
        with open(split_path) as f:
            corpus = prepare_corpus([d for d in json.load(f)
                                     if d["scene_id"] in scenes])
        intermediates = {} if args.save_interm else None
        with counted(stats, "caption", len(val_loader)):
            bleu, cider, rouge, meteor = eval_cap(
                eval_step, val_ds, val_loader, organized,
                min_iou=args.min_iou, corpus=corpus, use_nms=not args.no_nms,
                intermediates=intermediates, device=device)
        if args.save_interm and main:
            interm_path = os.path.join(folder, "interm.json")
            with open(interm_path, "w") as f:
                json.dump(intermediates, f)
            print(f"saved intermediate results to {interm_path}")
        if main:
            print(f"[BLEU-1] {bleu[0][0]:.4f}")
            print(f"[BLEU-2] {bleu[0][1]:.4f}")
            print(f"[BLEU-3] {bleu[0][2]:.4f}")
            print(f"[BLEU-4] {bleu[0][3]:.4f}")
            print(f"[CIDEr]  {cider[0]:.4f}")
            print(f"[ROUGE]  {rouge[0]:.4f}")
            print(f"[METEOR] {meteor[0]:.4f}", flush=True)
        results["caption"] = dict(bleu=bleu[0], cider=cider[0],
                                  rouge=rouge[0], meteor=meteor[0])

    if args.eval_detection:
        calcs = {t: APCalculator(t) for t in (0.25, 0.5)}
        emb = torch.as_tensor(train_ds.emb_table).to(device)
        with counted(stats, "detection", len(val_loader)):
            for batch in val_loader:
                tb = to_device(batch, device)
                tb["glove_emb_table"] = emb
                out = eval_step(tb)
                # the input cloud makes remove_empty_box active (POST_DICT)
                parsed = {k: v.cpu().numpy() for k, v in
                          parse_predictions_device(
                              {**out, "point_clouds": tb["point_clouds"]}
                          ).items()}
                preds = assemble_pred_map_cls(
                    out["bbox_corner"].cpu().numpy(), parsed)
                gts = parse_groundtruths(batch)
                for c in calcs.values():
                    c.step(preds, gts)
        results["detection"] = {}
        for t, c in calcs.items():
            metrics = c.compute_metrics()
            results["detection"][t] = metrics
            if main:
                print(f"--- mAP@{t}: {metrics['mAP']:.4f}  "
                      f"AR@{t}: {metrics['AR']:.4f}", flush=True)
    val_loader.close()
    if main:
        with open(os.path.join(folder, "eval_stats.json"), "w") as f:
            json.dump(stats, f)
    return results


def _rank(args):
    np.random.seed(args.seed)
    return evaluate(args)


def main(argv=None):
    from scan2cap_torch.scripts import eval as this
    from scan2cap_torch.scripts.train import on_mesh
    args = build_parser().parse_args(argv)
    np.random.seed(args.seed)
    return on_mesh(args, this._rank)


if __name__ == "__main__":
    main()
