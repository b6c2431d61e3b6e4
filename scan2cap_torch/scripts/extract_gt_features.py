"""GT-box feature extraction with a trained MaskVoteNet:
``python -m scan2cap_torch.scripts.extract_gt_features`` (counterpart of
``scripts/extract_gt_features.py``; reference
scripts/extract_gt_features.py:100-165, 227-240).

Runs MaskVoteNet's eval forward on ``--device`` (default ``cuda``) over
every (scene, object) pair of the split for ``--epoch`` augmented passes
(train; one unaugmented pass otherwise) and writes, per pass and scene in
the loader's order, the keys ``"{epoch}|{scene_id}_gt_ids"``,
``_features`` (the aggregated vote feature, 128-d), ``_bbox_corners`` and
``_gt_corners`` to a feature store (``data/feature_store.py``; default
``SCAN2CAP_DATA/gt_{dataset}_features_{split}.npz``): the database of
``PretrainedGTDataset``.  The weights come from a port run (``--folder``,
its info.json giving the input flags) or a reference-layout ``.pth``
(``--pth``, the input flags from this command line).  The last line of the
output, ``extract_stats {...}``, gives the passes' batches, seconds and
kernel launches.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from collections import defaultdict

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--folder", type=str, default="",
                   help="a MaskVoteNet run of the port (under "
                        "SCAN2CAP_OUTPUT)")
    p.add_argument("--pth", type=str, default="",
                   help="MaskVoteNet weights in the reference's .pth layout; "
                        "the model's input flags come from this command line")
    p.add_argument("--num_points", type=int, default=40000)
    p.add_argument("--no_height", action="store_true")
    p.add_argument("--use_color", action="store_true")
    p.add_argument("--use_normal", action="store_true")
    p.add_argument("--use_multiview", action="store_true")
    p.add_argument("--dataset", type=str, default="ScanRefer")
    p.add_argument("--split", type=str, default="train")
    p.add_argument("--epoch", type=int, default=100,
                   help="number of augmented passes (train)")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="the device to run on (cuda, or cpu)")
    return p


class ExtractStats:
    """Batches, samples, seconds and kernel launches of an extraction."""

    def __init__(self):
        from scan2cap_torch.kernels import launch_counts
        self._counts = launch_counts
        self._before = launch_counts()
        self.t0 = time.perf_counter()
        self.samples = 0
        self.forward_ms = []

    def forward(self, fn, batch_size, sync):
        t0 = time.perf_counter()
        out = fn()
        sync()
        self.forward_ms.append((time.perf_counter() - t0) * 1e3)
        self.samples += batch_size
        return out

    def report(self, out_path: str, keys: int) -> dict:
        """``forward_ms``: each batch's forward and its copy to the host
        (the first one builds); ``seconds``: the whole extraction."""
        return dict(batches=len(self.forward_ms), samples=self.samples,
                    seconds=time.perf_counter() - self.t0,
                    forward_ms=self.forward_ms, keys=keys,
                    store_bytes=os.path.getsize(out_path),
                    launches={k: v - self._before[k]
                              for k, v in self._counts().items()})


def device_sync(device):
    import torch
    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


def extract(args) -> dict:
    import torch

    from scan2cap_torch.config import PathConfig
    from scan2cap_torch.convert import state_dict_from_reference
    from scan2cap_torch.data.dataset import Loader, get_scanrefer
    from scan2cap_torch.data.dataset_maskvotenet import (
        MaskScannetReferenceDataset)
    from scan2cap_torch.data.feature_store import FeatureStoreWriter
    from scan2cap_torch.data.synthetic import to_device
    from scan2cap_torch.device import resolve_device
    from scan2cap_torch.models.mask_votenet import MaskVoteNet
    from scan2cap_torch.scripts.train_maskvotenet import (
        model_config_from_args)
    from scan2cap_torch.train.checkpoints import CheckpointIO

    if not args.folder and not args.pth:
        raise SystemExit("need --folder (a trained run) or --pth (released "
                         "extractor weights)")
    device = resolve_device(args.device)
    paths = PathConfig()
    if args.folder:
        folder = os.path.join(paths.output, args.folder)
        with open(os.path.join(folder, "info.json")) as f:
            info = json.load(f)
    else:
        info = vars(args)
    mcfg = model_config_from_args(argparse.Namespace(
        num_points=info["num_points"],
        no_height=info.get("no_height", False),
        use_color=info.get("use_color", False),
        use_normal=info.get("use_normal", False),
        use_multiview=info.get("use_multiview", False)))

    train_path = os.path.join(paths.data, f"{args.dataset}_filtered_train.json")
    val_path = os.path.join(paths.data, f"{args.dataset}_filtered_val.json")
    _, _, _, all_scenes = get_scanrefer(train_path, val_path)
    with open(os.path.join(paths.data,
                           f"{args.dataset}_filtered_{args.split}.json")) as f:
        entries = json.load(f)
    ds = MaskScannetReferenceDataset(
        entries, all_scenes, scannet_data_dir=paths.scannet_data,
        glove_path=paths.glove, num_points=mcfg.num_points,
        use_height=mcfg.use_height, use_color=mcfg.use_color,
        use_normal=mcfg.use_normal, use_multiview=mcfg.use_multiview,
        multiview_path=paths.multiview, augment=args.split == "train")
    loader = Loader(ds, args.batch_size, shuffle=False, seed=args.seed,
                    drop_last=False)

    model = MaskVoteNet(mcfg, device=device, seed=args.seed)
    if args.pth:
        # MaskVoteNet's reference tree has VoteNet's module names, so the
        # reference layout carries it (convert.py)
        sd = state_dict_from_reference(args.pth)
    else:
        sd = CheckpointIO(os.path.join(folder, "ckpt")).restore_best_or_last(
        )["model"]
    model.load_state_dict(sd, strict=True)
    model.eval()
    sync = device_sync(device)

    def forward(tbatch):
        with torch.inference_mode():
            out = model(tbatch, train=False)
        return out["aggregated_vote_features"][:, 0].cpu().numpy()  # (B, 128)

    out_path = args.out or os.path.join(
        paths.data, f"gt_{args.dataset}_features_{args.split}.npz")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    n_epochs = args.epoch if args.split == "train" else 1
    stats = ExtractStats()
    keys = 0
    with FeatureStoreWriter(out_path) as db:
        for epoch in range(n_epochs):
            per_scene = defaultdict(lambda: {"ids": [], "feats": [],
                                             "corners": []})
            loader.epoch = epoch
            for batch in loader:
                tbatch = to_device(batch, device)
                feats = stats.forward(lambda: forward(tbatch),
                                      len(batch["dataset_idx"]), sync)
                for b in range(len(feats)):
                    scene_id = ds.scanrefer[
                        int(batch["dataset_idx"][b])]["scene_id"]
                    s = per_scene[scene_id]
                    s["ids"].append(int(batch["object_id"][b]))
                    s["feats"].append(feats[b])
                    s["corners"].append(np.asarray(
                        batch["bbox_corner_label"][b]))
            for scene_id, s in per_scene.items():
                prefix = f"{epoch}|{scene_id}"
                corners = np.stack(s["corners"])
                db[prefix + "_gt_ids"] = np.asarray(s["ids"])
                db[prefix + "_features"] = np.stack(s["feats"])
                db[prefix + "_bbox_corners"] = corners
                db[prefix + "_gt_corners"] = corners
                keys += 4
            print(f"epoch {epoch}: {len(per_scene)} scenes", flush=True)
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
