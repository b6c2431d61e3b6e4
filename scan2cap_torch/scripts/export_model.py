"""A trained run's eval forward as a serving artifact:
``python -m scan2cap_torch.scripts.export_model`` (counterpart of
``scripts/export_model.py``).

Exports the CapNet eval step (detection and the caption decode of every
proposal, the weights baked in) with ``torch.export`` as one program:
point clouds (B, num_points, 3 + input_feature_dim) float32 in, and out
``tokens`` (int32 ids), ``bbox_corner``, ``objectness_scores`` and
``sem_cls_scores``.  The decoder's first input is the ``sos`` embedding,
as the dataset gives it at eval time; the shapes are static.  Beside the
program, ``<out>.vocab.json`` holds the vocabulary's ``idx2word``.

FPS, the ball query and the row gather stay in the program as the custom
ops of ``scan2cap_torch.ops.library`` (``scan2cap::furthest_point_sample``,
``scan2cap::ball_query``, ``scan2cap::group_points``): the hand-written
kernels on the card, their plain versions on the CPU.  The program is
traced on ``--device`` and saved with its weights on the CPU; the loader
moves it to the device it runs on (``torch.export.passes.
move_to_device_pass``), so one artifact serves on the card and on the CPU.

Loading needs ``torch`` and ``scan2cap_torch.ops.library``, which
registers the three ops, and nothing else of the model's code.  That is
the one difference from the JAX package's artifact, which needs only
``jax``.

Run:  python -m scan2cap_torch.scripts.export_model --folder <run> \\
          [--out PATH] [--batch_size 1] [--device cuda]
Load: python -m scan2cap_torch.scripts.export_model --load PATH --check \\
          [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--folder", type=str, default=None,
                   help="trained run folder (ckpt/ + info.json) under "
                        "SCAN2CAP_OUTPUT")
    p.add_argument("--out", type=str, default=None,
                   help="the artifact's path (default <run>/model.pt2)")
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--dataset", type=str, default="ScanRefer")
    p.add_argument("--load", type=str, default=None,
                   help="load an exported artifact instead")
    p.add_argument("--check", action="store_true",
                   help="after --load, run it on random inputs")
    p.add_argument("--device", type=str, default="cuda",
                   help="the device to trace on, or to run the loaded "
                        "program on (cuda, or cpu)")
    return p


class Serve(torch.nn.Module):
    """The JAX package's ``serve``: point clouds -> tokens, boxes and
    scores, through ``model``'s eval forward (no teacher forcing, no
    detection loss), with the embedding table and the ``sos`` vector as
    buffers."""

    def __init__(self, model: torch.nn.Module, emb_table: torch.Tensor,
                 sos: torch.Tensor):
        super().__init__()
        self.model = model
        self.register_buffer("emb_table", emb_table)
        self.register_buffer("sos", sos)

    def batch(self, point_clouds: torch.Tensor) -> dict:
        """The eval forward's input: the clouds, the sos-seeded language
        slots and the embedding table."""
        cfg = self.model.cfg
        lang = torch.zeros((point_clouds.shape[0], cfg.max_des_len + 2,
                            cfg.emb_size), dtype=torch.float32,
                           device=point_clouds.device)
        # serving decodes from sos only; the decoder reads slot 0, which a
        # zero vector there would shift
        lang[:, 0] = self.sos
        return {"point_clouds": point_clouds, "lang_feat": lang,
                "glove_emb_table": self.emb_table}

    @staticmethod
    def outputs(out: dict) -> dict:
        """What serving returns of the eval forward's outputs."""
        return {"tokens": out["lang_cap"].to(torch.int32),
                "bbox_corner": out["bbox_corner"],
                "objectness_scores": out["objectness_scores"],
                "sem_cls_scores": out["sem_cls_scores"]}

    def forward(self, point_clouds: torch.Tensor) -> dict:
        from scan2cap_torch.models.stage_graph import kept
        # on a card the forward's outputs may be its stage graphs'
        # buffers, which its next call overwrites
        return kept(self.model, self.outputs(self.model(
            self.batch(point_clouds), use_tf=False, is_eval=True,
            train=False)))


def build_serve(folder: str, device, dataset: str = "ScanRefer"):
    """(Serve on ``device`` in eval mode, the ModelConfig, idx2word) of the
    run in ``folder``, with its best (else last) checkpoint."""
    from scan2cap_torch.config import PathConfig
    from scan2cap_torch.data.dataset import (ScannetReferenceDataset,
                                             get_scanrefer)
    from scan2cap_torch.models import CapNet
    from scan2cap_torch.scripts.train import (dataset_kwargs,
                                              model_config_from_info)
    from scan2cap_torch.train.checkpoints import CheckpointIO

    paths = PathConfig()
    with open(os.path.join(folder, "info.json")) as f:
        info = json.load(f)
    mcfg = model_config_from_info(info)
    train_path = os.path.join(paths.data, f"{dataset}_filtered_train.json")
    val_path = os.path.join(paths.data, f"{dataset}_filtered_val.json")
    scanrefer_train, _, _, all_scenes = get_scanrefer(train_path, val_path)
    train_ds = ScannetReferenceDataset(
        scanrefer_train, all_scenes, split="train", augment=False,
        **dataset_kwargs(paths, mcfg))
    model = CapNet(mcfg, num_vocabs=train_ds.num_vocabs,
                   num_vocabs_padded=int(info.get("num_vocabs_padded", 0)
                                         or 0),
                   device=device)
    model.load_state_dict(CheckpointIO(os.path.join(folder, "ckpt"))
                          .restore_best_or_last()["model"], strict=True)
    table = torch.as_tensor(train_ds.emb_table, dtype=torch.float32)
    sos = table[int(train_ds.vocabulary["word2idx"]["sos"])].clone()
    serve = Serve(model, table, sos).to(device).eval()
    return serve, mcfg, train_ds.vocabulary["idx2word"]


def export(serve: Serve, batch_size: int):
    """The exported program of ``serve`` at static shapes (batch_size,
    num_points, 3 + input_feature_dim), traced on its device."""
    cfg = serve.model.cfg
    device = serve.emb_table.device
    example = torch.zeros((batch_size, cfg.num_points,
                           3 + cfg.input_feature_dim), dtype=torch.float32,
                          device=device)
    with torch.no_grad():
        return torch.export.export(serve, (example,), strict=False)


def save(ep, out_path: str, idx2word: dict) -> None:
    """The program with its weights on the CPU, and its vocabulary."""
    from torch.export.passes import move_to_device_pass
    torch.export.save(move_to_device_pass(ep, "cpu"), out_path)
    with open(out_path + ".vocab.json", "w") as f:
        json.dump({"idx2word": idx2word}, f)


def load(path: str, device="cuda"):
    """The artifact at ``path`` as a callable module on ``device``:
    ``module(point_clouds) -> dict``."""
    import scan2cap_torch.ops.library  # noqa: F401  (the ops it calls)
    from torch.export.passes import move_to_device_pass

    ep = torch.export.load(path)
    return move_to_device_pass(ep, torch.device(device)).module()


def build_and_export(args) -> str:
    from scan2cap_torch.config import PathConfig
    from scan2cap_torch.device import resolve_device

    device = resolve_device(args.device)
    folder = os.path.join(PathConfig().output, args.folder)
    serve, mcfg, idx2word = build_serve(folder, device, args.dataset)
    t0 = time.perf_counter()
    ep = export(serve, args.batch_size)
    export_s = time.perf_counter() - t0
    out_path = args.out or os.path.join(folder, "model.pt2")
    save(ep, out_path, idx2word)
    print(f"exported {out_path} ({os.path.getsize(out_path) / 1e6:.1f} MB, "
          f"traced on {device} in {export_s:.1f} s) + {out_path}.vocab.json;"
          f" input (B={args.batch_size}, N={mcfg.num_points}, "
          f"C={3 + mcfg.input_feature_dim}) float32", flush=True)
    return out_path


def load_and_check(args):
    """(the loaded module, its outputs on random input with ``--check``,
    else None)."""
    from scan2cap_torch.device import resolve_device

    device = resolve_device(args.device)
    t0 = time.perf_counter()
    module = load(args.load, device)
    print(f"loaded {args.load} on {device} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if not args.check:
        return module, None
    spec = next(n for n in module.graph.nodes if n.op == "placeholder"
                and n.name.startswith("point_clouds")).meta["val"]
    g = torch.Generator().manual_seed(0)
    x = torch.randn(tuple(spec.shape), generator=g).to(device)
    with torch.no_grad():
        out = module(x)
    print(f"check ok: tokens {tuple(out['tokens'].shape)} "
          f"boxes {tuple(out['bbox_corner'].shape)}", flush=True)
    return module, out


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.load:
        return load_and_check(args)
    if not args.folder:
        raise SystemExit("--folder or --load required")
    return build_and_export(args)


if __name__ == "__main__":
    main()
