"""A trained run's predictions on one scene as PLYs:
``python -m scan2cap_torch.scripts.visualize`` (counterpart of
``scripts/visualize.py``).

Rebuilds the model from the run's ``info.json`` (a ``--bf16`` run as it
trained), loads its best (else last) checkpoint, and runs the scene's
first validation description through the eval step with the detection
loss on ``--device`` (default ``cuda``): the per-object box PLYs are named
by the GT object each kept proposal is assigned to.  Proposals are kept by
3D NMS at IoU 0.25 within a class, over the objectness probability, and by
an objectness argmax of 1.  Writes under ``<run>/vis/<scene_id>/``:

  * ``scene.ply``: the input points, in their colours with ``use_color``,
    else grey 180;
  * ``pred_boxes.ply`` (green) and ``pred-<object id>.ply`` (the NYU40
    palette, ``object_id % 40``) for the kept proposals;
  * ``gt_boxes.ply`` (blue) and ``gt-<object id>.ply`` for the GT boxes;
  * ``captions.json``: proposal index -> decoded caption of each kept one.

The file names, colours and JSON keys are the JAX script's.

Run: python -m scan2cap_torch.scripts.visualize --folder <run> \\
        --scene_id scene0000_00 [--dataset ScanRefer] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--folder", type=str, required=True)
    p.add_argument("--scene_id", type=str, required=True)
    p.add_argument("--dataset", type=str, default="ScanRefer")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", type=str, default="cuda",
                   help="the device to run on (cuda, or cpu)")
    return p


def kept_proposals(out) -> np.ndarray:
    """(K,) bool of the first scene: NMS at IoU 0.25 within a class over
    the objectness probability, and objectness argmax 1."""
    import torch

    from scan2cap_torch.ops.nms import nms_3d

    obj_prob = torch.softmax(out["objectness_scores"], -1)[..., 1]
    cls = torch.argmax(out["sem_cls_scores"], -1)
    keep = nms_3d(out["bbox_corner"], obj_prob, cls, 0.25, True)
    keep = keep & (torch.argmax(out["objectness_scores"], -1) == 1)
    return keep.cpu().numpy()[0]


def visualize(args) -> str:
    import torch

    from scan2cap_torch.config import MEAN_COLOR_RGB, PathConfig
    from scan2cap_torch.data.dataset import (ScannetReferenceDataset,
                                             get_scanrefer)
    from scan2cap_torch.data.synthetic import to_device
    from scan2cap_torch.device import resolve_device
    from scan2cap_torch.eval.eval_helper import decode_caption
    from scan2cap_torch.models import CapNet
    from scan2cap_torch.scripts.train import (dataset_kwargs,
                                              model_config_from_info)
    from scan2cap_torch.train.checkpoints import CheckpointIO
    from scan2cap_torch.train.step import make_eval_step
    from scan2cap_torch.utils.colors import object_color
    from scan2cap_torch.utils.pc_utils import write_bbox_ply
    from scan2cap_torch.utils.ply import write_ply

    device = resolve_device(args.device)
    paths = PathConfig()
    folder = os.path.join(paths.output, args.folder)
    with open(os.path.join(folder, "info.json")) as f:
        info = json.load(f)
    mcfg = model_config_from_info(info)

    train_path = os.path.join(paths.data, f"{args.dataset}_filtered_train.json")
    val_path = os.path.join(paths.data, f"{args.dataset}_filtered_val.json")
    scanrefer_train, _, _, all_scenes = get_scanrefer(train_path, val_path)
    with open(val_path) as f:
        entries = [d for d in json.load(f) if d["scene_id"] == args.scene_id]
    if not entries:
        raise SystemExit(f"scene {args.scene_id} not in val split")

    # the JAX script's dataset arguments (max_num_obj at its default)
    common = dataset_kwargs(paths, mcfg)
    del common["max_num_obj"]
    train_ds = ScannetReferenceDataset(
        scanrefer_train, all_scenes, split="train", augment=False, **common)
    ds = ScannetReferenceDataset(
        entries[:1], all_scenes, split="val", augment=False,
        vocab=train_ds.vocabulary, glove=train_ds.glove, **common)

    sample = ds.__getitem__(0, rs=np.random.RandomState(args.seed))
    batch = to_device({k: np.asarray(v)[None] for k, v in sample.items()},
                      device)
    batch["glove_emb_table"] = torch.as_tensor(train_ds.emb_table).to(device)

    model = CapNet(mcfg, num_vocabs=train_ds.num_vocabs,
                   num_vocabs_padded=int(info.get("num_vocabs_padded", 0)
                                         or 0),
                   device=device, seed=args.seed)
    model.load_state_dict(CheckpointIO(os.path.join(folder, "ckpt"))
                          .restore_best_or_last()["model"], strict=True)
    # detection_loss=True: the per-object box PLYs are named and coloured
    # by the ASSIGNED GT object id (reference visualize.py:375), which
    # comes from the detection loss's object_assignment
    out = make_eval_step(mcfg, model, detection_loss=True)(batch)
    keep = kept_proposals(out)
    corners = out["bbox_corner"].cpu().numpy()[0]
    caps = out["lang_cap"].cpu().numpy()[0]

    out_dir = os.path.join(folder, "vis", args.scene_id)
    os.makedirs(out_dir, exist_ok=True)

    pc = np.asarray(sample["point_clouds"])
    rgb = ((pc[:, 3:6] * 256.0 + MEAN_COLOR_RGB).clip(0, 255).astype(np.uint8)
           if mcfg.use_color else
           np.full((len(pc), 3), 180, np.uint8))
    write_ply(os.path.join(out_dir, "scene.ply"), pc[:, :3], rgb)

    det_ids = np.asarray(sample["scene_object_ids"])
    if keep.any():
        write_bbox_ply(os.path.join(out_dir, "pred_boxes.ply"),
                       corners[keep], color=(0, 255, 0))
        assignment = out["object_assignment"][0].cpu().numpy().astype(int)
        for k in np.where(keep)[0]:
            oid = int(det_ids[assignment[k]])
            write_bbox_ply(os.path.join(out_dir, f"pred-{oid}.ply"),
                           corners[k][None], color=object_color(oid))
    gt_mask = np.asarray(sample["gt_box_masks"]) == 1
    gt_corners = np.asarray(sample["gt_box_corner_label"])
    write_bbox_ply(os.path.join(out_dir, "gt_boxes.ply"),
                   gt_corners[gt_mask], color=(0, 0, 255))
    for i in np.where(gt_mask)[0]:
        oid = int(np.asarray(sample["gt_box_object_ids"])[i])
        write_bbox_ply(os.path.join(out_dir, f"gt-{oid}.ply"),
                       gt_corners[i][None], color=object_color(oid))

    captions = {
        str(int(k)): decode_caption(caps[k], ds.vocabulary["idx2word"])
        for k in np.where(keep)[0]}
    with open(os.path.join(out_dir, "captions.json"), "w") as f:
        json.dump(captions, f, indent=4)
    print(f"wrote visualization to {out_dir} "
          f"({int(keep.sum())} predicted boxes)")
    return out_dir


def main(argv=None) -> str:
    return visualize(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
