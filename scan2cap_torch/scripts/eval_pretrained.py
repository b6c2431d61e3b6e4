"""Evaluation of a caption-only run:
``python -m scan2cap_torch.scripts.eval_pretrained`` (counterpart of
``scripts/eval_pretrained.py``; reference scripts/eval_pretrained.py and
lib/eval_helper_pretrained.py).

Rebuilds ``CapNetPretrained`` from a run folder's info.json on ``--device``
(default ``cuda``), loads its best (else last) checkpoint, decodes a
caption for every stored box of one sample a val scene and prints BLEU-4,
CIDEr, ROUGE and METEOR.  "gt" mode keys the candidates by the stored
object ids; "votenet" mode keeps the proposals over ``--min_iou`` with the
reference box.  ``eval_stats.json`` in the run folder keeps the pass's
batches, seconds and kernel launches.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--folder", type=str, required=True)
    p.add_argument("--dataset", type=str, default="ScanRefer")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--min_iou", type=float, default=0.5)
    p.add_argument("--features", type=str, default=None,
                   help="the val feature store (or an HDF5 file, with h5py)")
    p.add_argument("--device", type=str, default="cuda",
                   help="the device to run on (cuda, or cpu)")
    return p


def evaluate(args) -> dict:
    from scan2cap_torch.config import PathConfig
    from scan2cap_torch.data.dataset import Loader, get_scanrefer
    from scan2cap_torch.data.vocab import build_vocabulary, load_glove
    from scan2cap_torch.device import resolve_device
    from scan2cap_torch.eval.eval_helper import prepare_corpus, score_captions
    from scan2cap_torch.eval.eval_pretrained import feed_pretrained_cap
    from scan2cap_torch.models.capnet_pretrained import CapNetPretrained
    from scan2cap_torch.scripts.eval import counted
    from scan2cap_torch.scripts.train_pretrained import (
        default_features, model_config_from_info, one_per_scene,
        pretrained_dataset)
    from scan2cap_torch.train.checkpoints import CheckpointIO
    from scan2cap_torch.train.step import make_eval_step

    device = resolve_device(args.device)
    paths = PathConfig()
    folder = os.path.join(paths.output, args.folder)
    with open(os.path.join(folder, "info.json")) as f:
        info = json.load(f)
    mode = info["mode"]
    mcfg = model_config_from_info(info)

    train_path = os.path.join(paths.data, f"{args.dataset}_filtered_train.json")
    val_path = os.path.join(paths.data, f"{args.dataset}_filtered_val.json")
    scanrefer_train, _, _, _ = get_scanrefer(train_path, val_path)
    with open(val_path) as f:
        val_entries = json.load(f)

    glove = load_glove(paths.glove)
    feats = args.features or default_features(paths, args.dataset, mode,
                                              "val")
    ds = pretrained_dataset(mode)(
        one_per_scene(val_entries), feats, split="val", glove=glove,
        vocab=build_vocabulary(scanrefer_train, glove),
        K=mcfg.num_proposals)
    loader = Loader(ds, args.batch_size, shuffle=False, seed=args.seed,
                    drop_last=False)

    model = CapNetPretrained(mcfg, mode=mode, num_vocabs=ds.num_vocabs,
                             device=device, seed=args.seed)
    model.load_state_dict(CheckpointIO(os.path.join(folder, "ckpt"))
                          .restore_best_or_last()["model"], strict=True)
    eval_step = make_eval_step(mcfg, model, detection_loss=False)

    with open(os.path.join(paths.data,
                           "ScanRefer_filtered_organized.json")) as f:
        organized = json.load(f)
    stats = {}
    with counted(stats, "caption", len(loader)):
        candidates = feed_pretrained_cap(eval_step, ds, loader, organized,
                                         mode=mode, min_iou=args.min_iou,
                                         device=device)
    loader.close()

    bleu, cider, rouge, meteor = score_captions(prepare_corpus(val_entries),
                                                candidates)
    print(f"[BLEU-4] {bleu[0][3]:.4f}")
    print(f"[CIDEr]  {cider[0]:.4f}")
    print(f"[ROUGE]  {rouge[0]:.4f}")
    print(f"[METEOR] {meteor[0]:.4f}", flush=True)
    stats["candidates"] = len(candidates)
    with open(os.path.join(folder, "eval_stats.json"), "w") as f:
        json.dump(stats, f)
    return dict(bleu=bleu[0], cider=cider[0], rouge=rouge[0],
                meteor=meteor[0], candidates=candidates)


def main(argv=None):
    args = build_parser().parse_args(argv)
    np.random.seed(args.seed)
    return evaluate(args)


if __name__ == "__main__":
    main()
