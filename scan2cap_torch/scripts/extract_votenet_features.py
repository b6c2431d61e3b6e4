"""VoteNet proposal-feature extraction with a trained detector:
``python -m scan2cap_torch.scripts.extract_votenet_features`` (counterpart
of ``scripts/extract_votenet_features.py``; reference
scripts/extract_votenet_features.py:125-206).

Runs CapNet's detection path (``no_caption``) on ``--device`` (default
``cuda``) over one sample a scene of the split, keeps the proposals that
survive class-aware NMS (IoU 0.25) and are objects by their own argmax, and
writes per scene ``"0|{scene_id}_object_ids"`` (the GT object each kept
proposal is assigned to), ``_features``, ``_bbox_corners``, ``_gt_ids``
and ``_gt_corners`` to a feature store (``data/feature_store.py``; default
``SCAN2CAP_DATA/votenet_{dataset}_predictions_{split}.npz``): the
database of ``PretrainedVoteNetDataset``.  The weights come from a port run
(``--folder``: its info.json gives the model's flags; a captioning run's
caption head is left out) or a reference-layout ``.pth`` (``--pth``, the
flags from this command line).  The last line of the output,
``extract_stats {...}``, gives the batches, seconds and kernel launches.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--folder", type=str, default="",
                   help="a (detection) CapNet run of the port")
    p.add_argument("--pth", type=str, default="",
                   help="VoteNet weights in the reference's .pth layout; the "
                        "model's flags come from this command line")
    p.add_argument("--num_points", type=int, default=40000)
    p.add_argument("--num_proposals", type=int, default=256)
    p.add_argument("--no_height", action="store_true")
    p.add_argument("--use_color", action="store_true")
    p.add_argument("--use_normal", action="store_true")
    p.add_argument("--use_multiview", action="store_true")
    p.add_argument("--dataset", type=str, default="ScanRefer")
    p.add_argument("--split", type=str, default="train")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="the device to run on (cuda, or cpu)")
    return p


def extract(args) -> dict:
    import torch

    from scan2cap_torch.config import PathConfig
    from scan2cap_torch.convert import mount_detection_weights
    from scan2cap_torch.data.dataset import (Loader, ScannetReferenceDataset,
                                             get_scanrefer)
    from scan2cap_torch.data.feature_store import FeatureStoreWriter
    from scan2cap_torch.data.synthetic import to_device
    from scan2cap_torch.data.vocab import build_vocabulary, load_glove
    from scan2cap_torch.device import resolve_device
    from scan2cap_torch.models import CapNet
    from scan2cap_torch.ops.nms import nms_3d
    from scan2cap_torch.scripts.extract_gt_features import (ExtractStats,
                                                            device_sync)
    from scan2cap_torch.scripts.train import (model_config_from_args,
                                              model_config_from_info)
    from scan2cap_torch.train.checkpoints import CheckpointIO
    from scan2cap_torch.train.step import make_eval_step

    if not args.folder and not args.pth:
        raise SystemExit("need --folder (a trained run) or --pth (released "
                         "detector weights)")
    device = resolve_device(args.device)
    paths = PathConfig()
    if args.folder:
        folder = os.path.join(paths.output, args.folder)
        with open(os.path.join(folder, "info.json")) as f:
            base = model_config_from_info(json.load(f))
    else:
        # the trainer's flags at their defaults, and this command's
        base = model_config_from_args(argparse.Namespace(
            num_points=args.num_points, num_proposals=args.num_proposals,
            num_locals=-1, num_graph_steps=0, query_mode="corner",
            graph_mode="edge_conv", graph_aggr="add", use_relation=False,
            use_orientation=False, use_distance=False, use_topdown=False,
            use_color=args.use_color, use_normal=args.use_normal,
            use_multiview=args.use_multiview, no_height=args.no_height,
            no_caption=True))
    mcfg = base.__class__(**{**base.__dict__, "no_caption": True})

    train_path = os.path.join(paths.data, f"{args.dataset}_filtered_train.json")
    val_path = os.path.join(paths.data, f"{args.dataset}_filtered_val.json")
    scanrefer_train, _, _, all_scenes = get_scanrefer(train_path, val_path)
    with open(os.path.join(paths.data,
                           f"{args.dataset}_filtered_{args.split}.json")) as f:
        split_data = json.load(f)
    by_scene = {}
    for d in split_data:
        by_scene.setdefault(d["scene_id"], d)
    entries = [by_scene[s] for s in sorted(by_scene)]

    glove = load_glove(paths.glove)
    ds = ScannetReferenceDataset(
        entries, all_scenes, split=args.split, augment=False,
        vocab=build_vocabulary(scanrefer_train, glove), glove=glove,
        scannet_data_dir=paths.scannet_data, glove_path=paths.glove,
        num_points=mcfg.num_points, use_height=mcfg.use_height,
        use_color=mcfg.use_color, use_normal=mcfg.use_normal,
        use_multiview=mcfg.use_multiview, multiview_path=paths.multiview)
    loader = Loader(ds, args.batch_size, shuffle=False, seed=args.seed,
                    drop_last=False)

    model = CapNet(mcfg, num_vocabs=ds.num_vocabs, device=device,
                   seed=args.seed)
    if args.pth:
        mount_detection_weights(model, args.pth)
    else:
        sd = CheckpointIO(os.path.join(folder, "ckpt")).restore_best_or_last(
        )["model"]
        model.load_state_dict({k: v for k, v in sd.items()
                               if not k.startswith("caption.")}, strict=True)
    eval_step = make_eval_step(mcfg, model)
    sync = device_sync(device)

    out_path = args.out or os.path.join(
        paths.data, f"votenet_{args.dataset}_predictions_{args.split}.npz")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    stats = ExtractStats()
    keys = 0
    with FeatureStoreWriter(out_path) as db:
        for batch in loader:
            tbatch = to_device(batch, device)
            out = stats.forward(lambda: eval_step(tbatch),
                                len(batch["dataset_idx"]), sync)
            scores = out["objectness_scores"]
            obj_prob = torch.softmax(scores, -1)[..., 1]
            cls = torch.argmax(out["sem_cls_scores"], -1)
            keep = nms_3d(out["bbox_corner"], obj_prob, cls, 0.25, True)
            keep = (keep & (torch.argmax(scores, -1) == 1)).cpu().numpy()
            feats = out["bbox_feature"].cpu().numpy()
            corners = out["bbox_corner"].cpu().numpy()
            assign = out["object_assignment"].cpu().numpy()
            for b in range(keep.shape[0]):
                scene_id = ds.scanrefer[
                    int(batch["dataset_idx"][b])]["scene_id"]
                idx = np.where(keep[b])[0]
                gt_mask = np.asarray(batch["gt_box_masks"][b]) == 1
                prefix = f"0|{scene_id}"
                db[prefix + "_object_ids"] = np.asarray(
                    batch["scene_object_ids"][b])[assign[b, idx]]
                db[prefix + "_features"] = feats[b, idx]
                db[prefix + "_bbox_corners"] = corners[b, idx]
                db[prefix + "_gt_ids"] = np.asarray(
                    batch["gt_box_object_ids"][b])[gt_mask]
                db[prefix + "_gt_corners"] = np.asarray(
                    batch["gt_box_corner_label"][b])[gt_mask]
                keys += 5
    loader.close()
    print(f"wrote {out_path}")
    report = stats.report(out_path, keys)
    print("extract_stats " + json.dumps(report), flush=True)
    return report


def main(argv=None):
    args = build_parser().parse_args(argv)
    np.random.seed(args.seed)
    return extract(args)


if __name__ == "__main__":
    main()
