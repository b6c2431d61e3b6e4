"""A port run as a reference-layout ``.pth``:
``python -m scan2cap_torch.scripts.export_pth`` (counterpart of
``scripts/export_pth.py``).

Reads the run's ``ckpt/best.pt`` (else ``last.pt``; ``--use_last`` takes
``last.pt``) under ``SCAN2CAP_OUTPUT/<folder>``.  A run that holds a graph
or a caption head is written as a FULL ``model.pth`` the reference's eval
and benchmark scripts strict-load (``convert.reference_from_state_dict``);
a detection-only run, or any run with ``--detection_only``, as the
backbone_net/vgen/proposal ``votenet.pth`` (``convert.
export_votenet_checkpoint``).  ``--num_vocabs`` slices a vocabulary-padded
classifier back to the real vocabulary.  A bfloat16 run exports like a
float32 one: neither mode adds a parameter, and every parameter is float32.

Run: python -m scan2cap_torch.scripts.export_pth --folder <run> \\
        [--use_last] [--detection_only] [--num_vocabs N] [--out PATH]
"""

from __future__ import annotations

import argparse
import os

import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--folder", type=str, required=True,
                   help="run folder (under SCAN2CAP_OUTPUT) holding ckpt/")
    p.add_argument("--use_last", action="store_true",
                   help="export last.pt instead of best.pt")
    p.add_argument("--out", type=str, default="",
                   help="destination .pth (default <folder>/model.pth for "
                        "full runs, votenet.pth for detection-only)")
    p.add_argument("--detection_only", action="store_true",
                   help="export only backbone_net/vgen/proposal even when "
                        "the run holds a full CapNet")
    p.add_argument("--num_vocabs", type=int, default=0,
                   help="real vocabulary size: slice a vocab-padded run's "
                        "classifier back to the reference width")
    return p


def export(args) -> str:
    from scan2cap_torch.config import PathConfig
    from scan2cap_torch.convert import (export_votenet_checkpoint,
                                        flax_from_state_dict,
                                        reference_from_state_dict)
    from scan2cap_torch.train.checkpoints import CheckpointIO

    folder = os.path.join(PathConfig().output, args.folder)
    ckpt = CheckpointIO(os.path.join(folder, "ckpt"))
    model = (ckpt.restore("last") if args.use_last
             else ckpt.restore_best_or_last())["model"]
    full = not args.detection_only and any(
        k.split(".")[0] in ("caption", "graph") for k in model)
    if full:
        out = args.out or os.path.join(folder, "model.pth")
        sd = reference_from_state_dict(model, args.num_vocabs or None)
        kind = "full model"
    else:
        out = args.out or os.path.join(folder, "votenet.pth")
        sd = export_votenet_checkpoint(*flax_from_state_dict(model))
        kind = "detection"
    torch.save(sd, out)
    print(f"exported {kind}: {len(sd)} tensors -> {out}")
    return out


def main(argv=None) -> str:
    return export(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
