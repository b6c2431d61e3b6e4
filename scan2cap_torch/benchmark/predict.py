"""Benchmark prediction CLI of the port:
``python -m scan2cap_torch.benchmark.predict`` (counterpart of
``benchmark/predict.py``).

Runs a port run's CapNet (best, else last checkpoint) over the scenes
``scene*_00`` of a split and writes ``<run>/pred.json``: per scene a list
of {"caption", "box" (8, 3), "sem_prob" (18,), "obj_prob" (2,)} for every
proposal that passes NMS and objectness (the reference's predict.py:192-233),
and ``<run>/predict_stats.json``: the batches, seconds and kernel launches.
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
    p.add_argument("--split", type=str, default="val")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", type=str, default="cuda",
                   help="the device to run on (cuda, or cpu)")
    return p


def predict_caption(args):
    import torch

    from scan2cap_torch.config import PathConfig
    from scan2cap_torch.data.dataset import (Loader, ScannetReferenceDataset,
                                             get_scanrefer)
    from scan2cap_torch.data.vocab import build_vocabulary, load_glove
    from scan2cap_torch.device import resolve_device
    from scan2cap_torch.models import CapNet
    from scan2cap_torch.scripts.eval import counted
    from scan2cap_torch.scripts.train import (dataset_kwargs,
                                              model_config_from_info)
    from scan2cap_torch.train.checkpoints import CheckpointIO
    from scan2cap_torch.train.step import make_eval_step

    device = resolve_device(args.device)
    paths = PathConfig()
    folder = os.path.join(paths.output, args.folder)
    with open(os.path.join(folder, "info.json")) as f:
        info = json.load(f)
    mcfg = model_config_from_info(info)

    train_path = os.path.join(paths.data, f"{args.dataset}_filtered_train.json")
    split_path = os.path.join(paths.data,
                              f"{args.dataset}_filtered_{args.split}.json")
    scanrefer_train, _, _, _ = get_scanrefer(train_path, split_path)
    with open(split_path) as f:
        split_data = json.load(f)
    # the benchmark runs scene*_00 only (predict.py:115-119)
    scene_list = sorted({d["scene_id"] for d in split_data
                         if d["scene_id"].endswith("_00")})
    by_scene = {}
    for d in split_data:
        by_scene.setdefault(d["scene_id"], d)
    eval_entries = [by_scene[s] for s in scene_list]

    # the vocabulary comes from the train split's tokens and GloVe alone:
    # no train scene is loaded
    glove = load_glove(paths.glove)
    vocabulary = build_vocabulary(scanrefer_train, glove)
    ds = ScannetReferenceDataset(
        eval_entries, scene_list, split=args.split, augment=False,
        vocab=vocabulary, glove=glove, **dataset_kwargs(paths, mcfg))
    loader = Loader(ds, args.batch_size, shuffle=False, seed=args.seed,
                    drop_last=False)

    model = CapNet(mcfg, num_vocabs=ds.num_vocabs,
                   num_vocabs_padded=int(info.get("num_vocabs_padded", 0)
                                         or 0),
                   device=device, seed=args.seed)
    bundle = CheckpointIO(os.path.join(folder, "ckpt")).restore_best_or_last()
    model.load_state_dict(bundle["model"], strict=True)
    eval_step = make_eval_step(mcfg, model, detection_loss=False)

    outputs, stats = {}, {}
    idx2word = ds.vocabulary["idx2word"]
    emb = torch.as_tensor(ds.emb_table).to(device)
    with counted(stats, "predict", len(loader)):
        _predict(loader, eval_step, emb, ds, idx2word, device, outputs)
    loader.close()

    out_path = os.path.join(folder, "pred.json")
    with open(out_path, "w") as f:
        json.dump(outputs, f)
    with open(os.path.join(folder, "predict_stats.json"), "w") as f:
        json.dump(stats, f)
    print(f"saved predictions for {len(outputs)} scenes to {out_path}",
          flush=True)
    return outputs


def _predict(loader, eval_step, emb, ds, idx2word, device, outputs):
    """Fill ``outputs`` (scene id -> entries) from every batch of ``loader``."""
    import torch

    from scan2cap_torch.data.synthetic import to_device
    from scan2cap_torch.eval.ap_helper import parse_predictions_device
    from scan2cap_torch.eval.eval_helper import decode_caption

    for batch in loader:
        tb = to_device(batch, device)
        tb["glove_emb_table"] = emb
        out = eval_step(tb)
        obj_prob = torch.softmax(out["objectness_scores"], dim=-1)
        sem_prob = torch.softmax(out["sem_cls_scores"], dim=-1)
        # remove_empty_box and class NMS on the device (POST_DICT,
        # benchmark/predict.py:161-192): the input cloud goes in too
        parsed = parse_predictions_device(
            {**out, "point_clouds": tb["point_clouds"]})
        keep = (parsed["pred_mask"]
                & (torch.argmax(out["objectness_scores"], -1) == 1)
                ).cpu().numpy()
        corners = out["bbox_corner"].cpu().numpy()
        caps = out["lang_cap"].cpu().numpy()
        obj_prob = obj_prob.cpu().numpy()
        sem_prob = sem_prob.cpu().numpy()
        for b in range(keep.shape[0]):
            scene_id = ds.scanrefer[int(batch["dataset_idx"][b])]["scene_id"]
            outputs[scene_id] = [{
                "caption": decode_caption(caps[b, k], idx2word),
                "box": corners[b, k].tolist(),
                "sem_prob": sem_prob[b, k].tolist(),
                "obj_prob": obj_prob[b, k].tolist(),
            } for k in np.where(keep[b])[0]]


def main(argv=None):
    args = build_parser().parse_args(argv)
    np.random.seed(args.seed)
    return predict_caption(args)


if __name__ == "__main__":
    main()
