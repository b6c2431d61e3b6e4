"""MaskVoteNet training CLI of the port:
``python -m scan2cap_torch.scripts.train_maskvotenet`` (counterpart of
``scripts/train_maskvotenet.py``; reference scripts/train_maskvotenet.py).

Trains the single-proposal feature extractor on ScanNet-layout scenes and
ScanRefer JSON from ``SCAN2CAP_DATA`` on ``--device`` (default ``cuda``;
the tests pass ``cpu``).  The solver runs the detection-only schedules (lr
and BN momentum decay), has no eval pass, selects by ``miou`` and writes
the run under ``SCAN2CAP_OUTPUT/<stamp>``: ``info.json``, ``log.txt``,
``scalars.json``, ``train_stats.json`` and ``ckpt/{last,resume}.pt``.
``last.pt``'s model converts to the reference's ``.pth`` layout with
``convert.reference_from_state_dict``.  ``--mesh DATA,MODEL`` trains over
DATA x MODEL ranks (``parallel.mesh``); MaskVoteNet has no caption
parameter, so the model axis replicates it.
"""

from __future__ import annotations

import argparse
import json
import os
from datetime import datetime

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--tag", type=str, default="")
    p.add_argument("--dataset", type=str, default="ScanRefer")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--epoch", type=int, default=20)
    p.add_argument("--verbose", type=int, default=10)
    p.add_argument("--val_step", type=int, default=2000)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--wd", type=float, default=1e-5)
    p.add_argument("--num_points", type=int, default=40000)
    p.add_argument("--no_height", action="store_true")
    p.add_argument("--no_augment", action="store_true")
    p.add_argument("--use_color", action="store_true")
    p.add_argument("--use_normal", action="store_true")
    p.add_argument("--use_multiview", action="store_true")
    p.add_argument("--mesh", type=str, default=None, metavar="DATA,MODEL",
                   help="train over DATA x MODEL ranks; this model has no "
                        "caption parameter, so MODEL replicates it")
    p.add_argument("--device", type=str, default="cuda",
                   help="the device to run on (cuda, or cpu)")
    return p


def model_config_from_args(args):
    from scan2cap_torch.config import ModelConfig
    # test hook: shrink the SA pyramid so fixture-size scenes run fast
    tiny = (dict(sa_npoints=(128, 64, 32, 16))
            if os.environ.get("SCAN2CAP_TEST_TINY") else {})
    return ModelConfig(
        num_points=args.num_points, num_proposals=1, max_num_obj=1,
        use_height=not args.no_height, use_color=args.use_color,
        use_normal=args.use_normal, use_multiview=args.use_multiview,
        no_caption=True, **tiny)


def train(args):
    from scan2cap_torch.config import PathConfig
    from scan2cap_torch.data.dataset import Loader, get_scanrefer
    from scan2cap_torch.data.dataset_maskvotenet import (
        MaskScannetReferenceDataset)
    from scan2cap_torch.device import resolve_device
    from scan2cap_torch.models.mask_votenet import MaskVoteNet
    from scan2cap_torch.parallel import mesh as pmesh
    from scan2cap_torch.scripts.train import mesh_line
    from scan2cap_torch.train.solver import Solver
    from scan2cap_torch.train.step import (create_train_state,
                                           make_mask_votenet_step)

    mesh = pmesh.current()
    device = mesh.device if mesh is not None else resolve_device(args.device)
    if mesh is not None and mesh.is_main:
        print(mesh_line(mesh), flush=True)
    paths = PathConfig()
    mcfg = model_config_from_args(args)

    train_path = os.path.join(paths.data,
                              f"{args.dataset}_filtered_train.json")
    val_path = os.path.join(paths.data, f"{args.dataset}_filtered_val.json")
    scanrefer_train, _, _, all_scenes = get_scanrefer(train_path, val_path)
    train_ds = MaskScannetReferenceDataset(
        scanrefer_train, all_scenes, split="train",
        scannet_data_dir=paths.scannet_data, glove_path=paths.glove,
        num_points=args.num_points, use_height=not args.no_height,
        use_color=args.use_color, use_normal=args.use_normal,
        use_multiview=args.use_multiview, multiview_path=paths.multiview,
        augment=not args.no_augment)
    # the solver's upload copies, so the ring slots can be reused; a rank
    # of a mesh loads its rows of each batch
    train_loader = Loader(train_ds, args.batch_size, shuffle=True,
                          seed=args.seed, reuse_buffers=True,
                          data_shard=(None if mesh is None
                                      else (mesh.d, mesh.n_data)))

    model = MaskVoteNet(mcfg, device=device, seed=args.seed)
    state = create_train_state(mcfg, model, wd=args.wd)
    train_step = make_mask_votenet_step(mcfg, state)

    stamp = pmesh.main_only(datetime.now().strftime,
                           "%Y-%m-%d_%H-%M-%S")
    if args.tag:
        stamp += "_" + args.tag.upper()
    solver = Solver(state, train_step, train_loader,
                    output=os.path.join(paths.output, stamp), lr=args.lr,
                    eval_fn=None, val_step=args.val_step, criterion="miou",
                    verbose=args.verbose, lr_decay=True, bn_decay=True)
    if pmesh.is_main():
        with open(os.path.join(solver.output, "info.json"), "w") as f:
            json.dump(dict(vars(args), num_train=len(train_ds)), f,
                      indent=4)
        print(f"start training... stamp: {stamp}", flush=True)
    solver(args.epoch, args.verbose)
    train_loader.close()
    return solver


def _rank(args):
    np.random.seed(args.seed)
    train(args)


def main(argv=None):
    from scan2cap_torch.scripts import train_maskvotenet as this
    from scan2cap_torch.scripts.train import on_mesh
    args = build_parser().parse_args(argv)
    np.random.seed(args.seed)
    if args.mesh:
        return on_mesh(args, this._rank, args.batch_size)
    return train(args)


if __name__ == "__main__":
    main()
