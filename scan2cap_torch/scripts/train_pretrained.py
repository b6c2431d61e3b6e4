"""Caption-only training over stored box features:
``python -m scan2cap_torch.scripts.train_pretrained`` (counterpart of
``scripts/train_pretrained.py``; reference scripts/train_pretrained.py).

Reads a feature store (``--features``; default
``SCAN2CAP_DATA/gt_{dataset}_features_train.npz`` in ``--mode gt`` and
``votenet_{dataset}_predictions_train.npz`` in ``--mode votenet``) and the
ScanRefer JSON, trains ``CapNetPretrained`` on ``--device`` (default
``cuda``) with the port's Solver, and writes the run under
``SCAN2CAP_OUTPUT/<stamp>``: ``info.json`` (read back by
``eval_pretrained``), ``log.txt``, ``scalars.json``, ``train_stats.json``
and ``ckpt/{best,last,resume}.pt``.  The caption eval runs in training
every ``--val_step`` iterations when the val store (the features' path
with its basename's last "train" made "val") and the organized JSON exist.
``--mesh DATA,MODEL`` trains over DATA x MODEL ranks (``parallel.mesh``):
the caption classifier and attention split over MODEL.
"""

from __future__ import annotations

import argparse
import json
import os
import re
from datetime import datetime

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--tag", type=str, default="")
    p.add_argument("--dataset", type=str, default="ScanRefer")
    p.add_argument("--mode", type=str, default="gt", choices=["gt", "votenet"])
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--epoch", type=int, default=50)
    p.add_argument("--verbose", type=int, default=10)
    p.add_argument("--val_step", type=int, default=2000)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--wd", type=float, default=1e-5)
    p.add_argument("--num_locals", type=int, default=-1)
    p.add_argument("--num_graph_steps", type=int, default=0)
    p.add_argument("--query_mode", type=str, default="center")
    p.add_argument("--graph_mode", type=str, default="edge_conv")
    p.add_argument("--graph_aggr", type=str, default="add")
    p.add_argument("--use_topdown", action="store_true")
    p.add_argument("--use_relation", action="store_true")
    p.add_argument("--use_orientation", action="store_true")
    p.add_argument("--use_distance", action="store_true")
    p.add_argument("--criterion", type=str, default="cider")
    p.add_argument("--features", type=str, default=None,
                   help="the feature store (or an HDF5 file, with h5py)")
    p.add_argument("--mesh", type=str, default=None, metavar="DATA,MODEL",
                   help="train over DATA x MODEL ranks: scenes over DATA, "
                        "the caption classifier and attention over MODEL")
    p.add_argument("--device", type=str, default="cuda",
                   help="the device to run on (cuda, or cpu)")
    return p


def model_config_from_info(info: dict):
    """The caption-only model's ModelConfig from a run's flags."""
    from scan2cap_torch.config import ModelConfig
    from scan2cap_torch.models.capnet_pretrained import MODES
    return ModelConfig(
        num_proposals=MODES[info["mode"]],
        num_locals=info["num_locals"],
        num_graph_steps=info["num_graph_steps"],
        query_mode=info["query_mode"], graph_mode=info["graph_mode"],
        graph_aggr=info["graph_aggr"], use_topdown=info["use_topdown"],
        use_relation=info["use_relation"],
        use_orientation=info["use_orientation"],
        use_distance=info["use_distance"])


def default_features(paths, dataset: str, mode: str, split: str) -> str:
    name = (f"gt_{dataset}_features_{split}.npz" if mode == "gt"
            else f"votenet_{dataset}_predictions_{split}.npz")
    return os.path.join(paths.data, name)


def val_features(path: str) -> str:
    """The val store beside a train store: the basename's last "train"
    becomes "val" (a directory named "retrain" stays as it is)."""
    head, base = os.path.split(path)
    return os.path.join(head, re.sub(r"train(?!.*train)", "val", base,
                                     count=1))


def pretrained_dataset(mode: str):
    from scan2cap_torch.data.dataset_pretrained import (
        PretrainedGTDataset, PretrainedVoteNetDataset)
    return PretrainedGTDataset if mode == "gt" else PretrainedVoteNetDataset


def one_per_scene(entries):
    """One entry a scene, scenes sorted: a caption for every box of a scene
    comes from one forward."""
    by_scene = {}
    for d in entries:
        by_scene.setdefault(d["scene_id"], d)
    return [by_scene[s] for s in sorted(by_scene)]


def train(args):
    from scan2cap_torch.config import PathConfig
    from scan2cap_torch.data.dataset import Loader, get_scanrefer
    from scan2cap_torch.data.vocab import load_glove
    from scan2cap_torch.device import resolve_device
    from scan2cap_torch.eval.eval_helper import prepare_corpus
    from scan2cap_torch.eval.eval_pretrained import eval_pretrained_cap
    from scan2cap_torch.models.capnet_pretrained import CapNetPretrained
    from scan2cap_torch.parallel import mesh as pmesh
    from scan2cap_torch.scripts.train import mesh_line
    from scan2cap_torch.train.solver import Solver
    from scan2cap_torch.train.step import (create_train_state,
                                           make_eval_step,
                                           make_pretrained_step)

    mesh = pmesh.current()
    device = mesh.device if mesh is not None else resolve_device(args.device)
    if mesh is not None and mesh.is_main:
        print(mesh_line(mesh), flush=True)
    paths = PathConfig()
    mcfg = model_config_from_info(vars(args))
    K = mcfg.num_proposals

    train_path = os.path.join(paths.data, f"{args.dataset}_filtered_train.json")
    val_path = os.path.join(paths.data, f"{args.dataset}_filtered_val.json")
    scanrefer_train, _, _, _ = get_scanrefer(train_path, val_path)
    glove = load_glove(paths.glove)

    scan2cad = None
    if args.use_orientation:
        with open(os.path.join(paths.data,
                               "scannet_instance_rotations.json")) as f:
            scan2cad = json.load(f)

    ds_cls = pretrained_dataset(args.mode)
    feats = args.features or default_features(paths, args.dataset, args.mode,
                                              "train")
    train_ds = ds_cls(scanrefer_train, feats, split="train", glove=glove,
                      scan2cad_rotation=scan2cad, K=K)
    # the solver's upload copies, so the ring slots can be reused; a rank
    # of a mesh loads its rows of each batch
    train_loader = Loader(train_ds, args.batch_size, shuffle=True,
                          seed=args.seed, reuse_buffers=True,
                          data_shard=(None if mesh is None
                                      else (mesh.d, mesh.n_data)))

    model = CapNetPretrained(mcfg, mode=args.mode,
                             num_vocabs=train_ds.num_vocabs, device=device,
                             seed=args.seed)
    if mesh is not None:
        pmesh.shard_model(model)
    state = create_train_state(mcfg, model, wd=args.wd)
    train_step = make_pretrained_step(mcfg, state, args.mode,
                                      orientation=args.use_orientation,
                                      distance=args.use_distance)

    # in-training caption eval (lib/solver_pretrained.py:283-295), when the
    # val store and the organized JSON are there
    eval_fn, val_loader = None, None
    val_db = (val_features(args.features) if args.features else
              default_features(paths, args.dataset, args.mode, "val"))
    organized_path = os.path.join(paths.data,
                                  "ScanRefer_filtered_organized.json")
    if os.path.exists(val_db) and os.path.exists(organized_path):
        with open(organized_path) as f:
            organized = json.load(f)
        with open(val_path) as f:
            val_entries = json.load(f)
        val_ds = ds_cls(one_per_scene(val_entries), val_db, split="val",
                        glove=glove, vocab=train_ds.vocabulary, K=K)
        val_loader = Loader(val_ds, args.batch_size, shuffle=False,
                            seed=args.seed, drop_last=False)
        corpus = prepare_corpus(val_entries)
        eval_step = make_eval_step(mcfg, model, detection_loss=False)
        if mesh is not None:
            eval_step = pmesh.mesh_eval_fn(eval_step)

        def eval_fn():
            bleu, cider, rouge, meteor = eval_pretrained_cap(
                eval_step, val_ds, val_loader, organized, corpus,
                mode=args.mode, device=device)
            return {"bleu-4": bleu[0][3], "cider": cider[0],
                    "rouge": rouge[0], "meteor": meteor[0]}

    stamp = pmesh.main_only(datetime.now().strftime,
                           "%Y-%m-%d_%H-%M-%S")
    if args.tag:
        stamp += "_" + args.tag.upper()
    solver = Solver(state, train_step, train_loader,
                    output=os.path.join(paths.output, stamp), lr=args.lr,
                    emb_table=train_ds.emb_table, eval_fn=eval_fn,
                    val_step=args.val_step, criterion=args.criterion,
                    verbose=args.verbose)
    if pmesh.is_main():
        with open(os.path.join(solver.output, "info.json"), "w") as f:
            json.dump(dict(vars(args), num_train=len(train_ds)), f,
                      indent=4)
        print(f"start training... stamp: {stamp}", flush=True)
    solver(args.epoch, args.verbose)
    train_loader.close()
    if val_loader is not None:
        val_loader.close()
    return solver


def _rank(args):
    np.random.seed(args.seed)
    train(args)


def main(argv=None):
    from scan2cap_torch.scripts import train_pretrained as this
    from scan2cap_torch.scripts.train import on_mesh
    args = build_parser().parse_args(argv)
    np.random.seed(args.seed)
    if args.mesh:
        return on_mesh(args, this._rank, args.batch_size)
    return train(args)


if __name__ == "__main__":
    main()
