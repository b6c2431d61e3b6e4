"""Training CLI of the port: ``python -m scan2cap_torch.scripts.train``
(counterpart of ``scripts/train.py``; the reference's scripts/train.py
flags, :306-350).

Reads ScanNet-layout scenes and ScanRefer JSON from ``SCAN2CAP_DATA``,
builds the Loader, CapNet and the train step on ``--device`` (default
``cuda``; the tests pass ``cpu``), runs the Solver, and writes the run under
``SCAN2CAP_OUTPUT/<stamp>``: ``info.json`` (the flags eval and predict read
back), ``log.txt``, ``scalars.json`` and ``ckpt/{best,last,resume}.pt``.
``--use_pretrained`` mounts the detection modules of a reference-layout
``.pth`` or of a port run; ``--use_checkpoint`` resumes a port run at its
next global epoch.  ``--mesh DATA,MODEL`` runs DATA x MODEL ranks
(``parallel.mesh``: NCCL on the card, gloo with ``--device cpu``);
``--spatial`` also splits the SA layers' query axis over MODEL.
"""

from __future__ import annotations

import argparse
import json
import os
from datetime import datetime
from typing import Optional

import numpy as np

SPATIAL_NEEDS_MESH = ("--spatial requires --mesh DATA,MODEL with MODEL>1 "
                      "(the SA query axis shards over the model axis)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--tag", type=str, default="")
    p.add_argument("--dataset", type=str, default="ScanRefer",
                   help="ScanRefer or ReferIt3D")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--epoch", type=int, default=20)
    p.add_argument("--verbose", type=int, default=10)
    p.add_argument("--val_step", type=int, default=2000)
    p.add_argument("--profile", type=int, default=0,
                   help="torch.profiler trace of N warm steps (after the "
                        "first); writes <run>/profile/trace.json")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--wd", type=float, default=1e-5)
    p.add_argument("--num_points", type=int, default=40000)
    p.add_argument("--num_proposals", type=int, default=256)
    p.add_argument("--num_locals", type=int, default=-1)
    p.add_argument("--num_scenes", type=int, default=-1)
    p.add_argument("--num_graph_steps", type=int, default=0)
    p.add_argument("--criterion", type=str, default="cider")
    p.add_argument("--query_mode", type=str, default="center")
    p.add_argument("--graph_mode", type=str, default="edge_conv")
    p.add_argument("--graph_aggr", type=str, default="add")
    p.add_argument("--no_height", action="store_true")
    p.add_argument("--no_augment", action="store_true")
    p.add_argument("--no_detection", action="store_true")
    p.add_argument("--no_caption", action="store_true")
    p.add_argument("--use_tf", action="store_true",
                   help="accepted as the reference accepts it; training "
                        "always teacher-forces and eval always decodes "
                        "free-running")
    p.add_argument("--use_color", action="store_true")
    p.add_argument("--use_normal", action="store_true")
    p.add_argument("--use_multiview", action="store_true")
    p.add_argument("--use_topdown", action="store_true")
    p.add_argument("--use_relation", action="store_true")
    p.add_argument("--use_orientation", action="store_true")
    p.add_argument("--use_distance", action="store_true")
    p.add_argument("--use_pretrained", type=str, default=None,
                   help="detection weights to start from: a reference-"
                        "layout .pth or the name of a port run")
    p.add_argument("--use_checkpoint", type=str, default="",
                   help="a port run to resume at its next epoch")
    p.add_argument("--spatial", action="store_true",
                   help="with --mesh DATA,MODEL (MODEL>1): also split every "
                        "SA layer's query axis over the MODEL axis "
                        "(ModelConfig.spatial_axis)")
    p.add_argument("--mesh", type=str, default=None, metavar="DATA,MODEL",
                   help="train over DATA x MODEL ranks: scenes split over "
                        "DATA, the caption classifier (padded to a "
                        "divisible width) and attention over MODEL; "
                        "checkpoints hold whole tensors")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 backbone MLP chain (compute_dtype; the "
                        "geometry and the kernels stay float32)")
    p.add_argument("--device", type=str, default="cuda",
                   help="the device to run on (cuda, or cpu)")
    return p


def check_spatial(args, mcfg, n_model: int) -> None:
    """JAX's checks of ``--spatial`` (scripts/train.py:244-253)."""
    if n_model < 2:
        raise SystemExit("--spatial shards the SA query axis over the MODEL "
                         "mesh axis; use --mesh with MODEL>1 (e.g. --mesh "
                         "4,2)")
    if [m for m in mcfg.sa_npoints if m % n_model]:
        raise SystemExit(f"--spatial needs every SA point count to divide "
                         f"the model axis ({n_model}); got "
                         f"sa_npoints={mcfg.sa_npoints}")


def on_mesh(args, fn, batch_size: Optional[int] = None):
    """``fn(args)`` in this process, or with ``args.mesh`` on every rank of
    the mesh (``parallel.mesh.launch``), returning rank 0's result.  A
    trainer passes its ``batch_size``, which the data axis must divide."""
    if not getattr(args, "mesh", None):
        return fn(args)
    from scan2cap_torch.parallel.mesh import launch, parse_mesh, setup_mesh
    if batch_size is None:
        try:
            spec = parse_mesh(args.mesh, args.device)
        except ValueError as e:
            raise SystemExit(str(e))
    else:
        spec = setup_mesh(args.mesh, batch_size, args.device)
    return launch(spec, args.device, fn, args)


def mesh_line(mesh, vocab=None, spatial: bool = False) -> str:
    """The JAX trainers' ``mesh:`` line."""
    return (f"mesh: data={mesh.n_data} model={mesh.n_model}"
            + (f" vocab padded {vocab[0]}->{vocab[1]}" if vocab else "")
            + (" spatial(SA query axis over model)" if spatial else ""))


def model_config_from_args(args):
    from scan2cap_torch.config import ModelConfig
    fields = dict(
        num_points=args.num_points,
        num_proposals=args.num_proposals,
        num_locals=args.num_locals,
        num_graph_steps=args.num_graph_steps,
        query_mode=args.query_mode,
        graph_mode=args.graph_mode,
        graph_aggr=args.graph_aggr,
        use_relation=args.use_relation,
        use_orientation=args.use_orientation,
        use_distance=args.use_distance,
        use_topdown=args.use_topdown,
        use_color=args.use_color,
        use_normal=args.use_normal,
        use_multiview=args.use_multiview,
        use_height=not args.no_height,
        no_caption=args.no_caption,
        compute_dtype=("bfloat16" if getattr(args, "bf16", False)
                       else "float32"),
        # point-axis sharding rides the mesh's model axis (--spatial)
        spatial_axis="model" if getattr(args, "spatial", False) else "",
    )
    # test hook: shrink the SA pyramid so fixture-size scenes run fast
    if os.environ.get("SCAN2CAP_TEST_TINY"):
        fields.update(sa_npoints=(128, 64, 32, 16), max_num_obj=16)
    return ModelConfig(**fields)


def model_config_from_info(info: dict):
    """The ModelConfig of a saved run (its info.json), for eval, predict,
    export and visualize: a ``--bf16`` run is rebuilt in bfloat16;
    ``--spatial`` changed only the training's layout and is dropped."""
    return model_config_from_args(
        argparse.Namespace(**{**info, "spatial": False}))


def dataset_kwargs(paths, mcfg) -> dict:
    return dict(
        scannet_data_dir=paths.scannet_data,
        glove_path=paths.glove,
        num_points=mcfg.num_points,
        max_num_obj=mcfg.max_num_obj,
        use_height=mcfg.use_height,
        use_color=mcfg.use_color,
        use_normal=mcfg.use_normal,
        use_multiview=mcfg.use_multiview,
        multiview_path=paths.multiview,
    )


def caption_scores(bleu, cider, rouge, meteor) -> dict:
    return {"bleu-1": bleu[0][0], "bleu-2": bleu[0][1],
            "bleu-3": bleu[0][2], "bleu-4": bleu[0][3],
            "cider": cider[0], "rouge": rouge[0], "meteor": meteor[0]}


def train(args):
    from scan2cap_torch.config import PathConfig
    from scan2cap_torch.convert import (DETECTION_MODULES,
                                        mount_detection_weights)
    from scan2cap_torch.data.dataset import (Loader, ScannetReferenceDataset,
                                             get_scanrefer)
    from scan2cap_torch.device import resolve_device
    from scan2cap_torch.eval.eval_helper import eval_cap, prepare_corpus
    from scan2cap_torch.models import CapNet
    from scan2cap_torch.parallel import mesh as pmesh
    from scan2cap_torch.train.checkpoints import CheckpointIO, restore_resume
    from scan2cap_torch.train.solver import Solver
    from scan2cap_torch.train.step import (create_train_state,
                                           make_eval_step, make_train_step)

    mesh = pmesh.current()
    device = mesh.device if mesh is not None else resolve_device(args.device)
    paths = PathConfig()
    mcfg = model_config_from_args(args)

    # ---- data ----
    train_path = os.path.join(paths.data,
                              f"{args.dataset}_filtered_train.json")
    val_path = os.path.join(paths.data, f"{args.dataset}_filtered_val.json")
    scanrefer_train, eval_train, eval_val, all_scenes = get_scanrefer(
        train_path, val_path, args.num_scenes)
    if args.debug:
        scanrefer_train = [scanrefer_train[0]] * args.batch_size
        eval_train = [scanrefer_train[0]]
        eval_val = [scanrefer_train[0]]

    scan2cad = None
    if args.use_orientation:
        with open(os.path.join(paths.data,
                               "scannet_instance_rotations.json")) as f:
            scan2cad = json.load(f)

    common = dataset_kwargs(paths, mcfg)
    train_ds = ScannetReferenceDataset(
        scanrefer_train, all_scenes, split="train",
        augment=not args.no_augment, scan2cad_rotation=scan2cad, **common)
    val_ds = ScannetReferenceDataset(
        eval_val, all_scenes, split="val", augment=False,
        vocab=train_ds.vocabulary, glove=train_ds.glove, **common)
    # the solver's upload copies, so the ring slots can be reused; a rank
    # of a mesh loads its rows of each batch, every rank the whole val set
    train_loader = Loader(train_ds, args.batch_size, shuffle=True,
                          seed=args.seed, reuse_buffers=True,
                          data_shard=(None if mesh is None
                                      else (mesh.d, mesh.n_data)))
    val_loader = Loader(val_ds, args.batch_size, shuffle=False,
                        seed=args.seed, drop_last=False)
    with open(os.path.join(paths.data,
                           "ScanRefer_filtered_organized.json")) as f:
        organized = json.load(f)

    resume_ckpt = None
    if args.use_checkpoint:
        resume_ckpt = os.path.join(paths.output, args.use_checkpoint)
    vocab_pad = 0
    if resume_ckpt:
        # a resumed run keeps its classifier's width
        with open(os.path.join(resume_ckpt, "info.json")) as f:
            vocab_pad = int(json.load(f).get("num_vocabs_padded", 0) or 0)
    if mesh is not None:
        # the classifier's vocabulary splits over the model axis: pad it
        # to a divisible width
        if not vocab_pad and mesh.n_model > 1:
            vocab_pad = pmesh.padded_vocab(train_ds.num_vocabs, mesh.n_model)
        if mesh.is_main:
            print(mesh_line(mesh, (train_ds.num_vocabs, vocab_pad)
                            if vocab_pad else None, args.spatial),
                  flush=True)

    # ---- model + state ----
    model = CapNet(mcfg, num_vocabs=train_ds.num_vocabs,
                   num_vocabs_padded=vocab_pad, device=device,
                   seed=args.seed)

    if args.use_pretrained:
        # warm-start the detection modules (scripts/train.py:82-105)
        if args.use_pretrained.endswith(".pth"):
            mount_detection_weights(model, args.use_pretrained)
        else:
            pre = CheckpointIO(os.path.join(
                paths.output, args.use_pretrained, "ckpt")
            ).restore_best_or_last()["model"]
            model.load_state_dict(
                {k: v for k, v in pre.items()
                 if k.split(".")[0] in DETECTION_MODULES}, strict=False)
    if mesh is not None:
        pmesh.shard_model(model)
    state = create_train_state(mcfg, model, wd=args.wd)

    start_epoch = 0
    if resume_ckpt:
        # the resume bundle {epoch, model, optimizer, step}
        # (lib/solver.py:502-510 checkpoint.tar), whole tensors that
        # restore into any mesh shape
        start_epoch = restore_resume(state, CheckpointIO(os.path.join(
            resume_ckpt, "ckpt")).restore("resume", map_location=device))
        if pmesh.is_main():
            print(f"resumed from {args.use_checkpoint} at epoch "
                  f"{start_epoch}", flush=True)

    train_step = make_train_step(
        mcfg, state, detection=not args.no_detection,
        caption=not args.no_caption, orientation=args.use_orientation,
        distance=args.use_distance, use_tf=args.use_tf)
    eval_step = make_eval_step(mcfg, model)
    if mesh is not None:
        eval_step = pmesh.mesh_eval_fn(eval_step)

    with open(val_path) as f:
        val_scenes = {e["scene_id"] for e in eval_val}
        corpus_val = prepare_corpus([d for d in json.load(f)
                                     if d["scene_id"] in val_scenes])

    def eval_fn():
        return caption_scores(*eval_cap(eval_step, val_ds, val_loader,
                                        organized, corpus=corpus_val,
                                        device=device))

    # one run folder: rank 0's stamp
    stamp = pmesh.main_only(datetime.now().strftime,
                           "%Y-%m-%d_%H-%M-%S")
    if args.tag:
        stamp += "_" + args.tag.upper()

    solver = Solver(
        state, train_step, train_loader,
        output=os.path.join(paths.output, stamp), lr=args.lr,
        emb_table=train_ds.emb_table,
        eval_fn=None if args.no_caption else eval_fn,
        val_step=args.val_step, criterion=args.criterion,
        verbose=args.verbose, lr_decay=args.no_caption,
        bn_decay=args.no_caption, profile_steps=args.profile)

    # info.json (scripts/train.py:183-197)
    info = dict(vars(args))
    info["num_train"] = len(train_ds)
    info["num_eval_val"] = len(val_ds)
    # eval, predict and export rebuild the classifier at the width the
    # checkpoint was saved with
    info["num_vocabs_padded"] = vocab_pad
    if pmesh.is_main():
        with open(os.path.join(solver.output, "info.json"), "w") as f:
            json.dump(info, f, indent=4)
        print(f"start training... stamp: {stamp}", flush=True)
    # global epochs: a resume continues the schedules at the restored epoch
    solver(args.epoch, args.verbose, start_epoch=start_epoch)
    train_loader.close()
    val_loader.close()
    return solver


def _rank(args):
    np.random.seed(args.seed)
    train(args)


def main(argv=None):
    from scan2cap_torch.scripts import train as this
    args = build_parser().parse_args(argv)
    np.random.seed(args.seed)
    if args.spatial and not args.mesh:
        raise SystemExit(SPATIAL_NEEDS_MESH)
    if args.mesh:
        from scan2cap_torch.parallel.mesh import launch, setup_mesh
        spec = setup_mesh(args.mesh, args.batch_size, args.device)
        if args.spatial:
            check_spatial(args, model_config_from_args(args), spec.n_model)
        return launch(spec, args.device, this._rank, args)
    return train(args)


if __name__ == "__main__":
    main()
