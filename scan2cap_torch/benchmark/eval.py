"""Benchmark evaluation CLI of the port: ``python -m scan2cap_torch.benchmark.eval``
(counterpart of ``benchmark/eval.py``; reference benchmark/eval.py).

Reads a ``pred.json`` (``scan2cap_torch.benchmark.predict``'s output) and
a GT bbox json (``scan2cap_torch.scripts.build_benchmark_gt``'s output),
prints caption P/R/F1 at IoU {0, 0.25, 0.5}, detection mAP at 0.25 and
0.5 and dense-caption mAP, and writes them to ``eval_results.json`` beside
the predictions.  NMS and the rotated assignment run on ``--device``
(default ``cuda``).
"""

from __future__ import annotations

import argparse
import json
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--path", type=str, required=True, help="pred.json path")
    p.add_argument("--gt_path", type=str, required=True,
                   help="GT bbox json (build_benchmark_gt's output)")
    p.add_argument("--split", type=str, default="val")
    p.add_argument("--no_caption", action="store_true")
    p.add_argument("--no_detection", action="store_true")
    p.add_argument("--no_densecap", action="store_true")
    p.add_argument("--verbose", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--rotated_boxes", action="store_true",
                   help="polygon-clip gIoU assignment for z-rotated boxes "
                        "(the reference's rotated_boxes=True path; ScanNet "
                        "boxes are axis-aligned, so the default matches its "
                        "evaluation)")
    p.add_argument("--device", type=str, default="cuda",
                   help="the device to run on (cuda, or cpu)")
    return p


def _plain(o):
    """The results as JSON: string keys, Python numbers."""
    if isinstance(o, dict):
        return {str(k): _plain(v) for k, v in o.items()}
    if isinstance(o, (list, tuple)):
        return [_plain(v) for v in o]
    if hasattr(o, "item"):
        return o.item()
    return o


def main(argv=None):
    args = build_parser().parse_args(argv)
    from scan2cap_torch.device import resolve_device
    from scan2cap_torch.eval.benchmark import evaluate

    device = resolve_device(args.device)
    with open(args.path) as f:
        predictions = json.load(f)
    with open(args.gt_path) as f:
        gt_json = json.load(f)
    results = evaluate(
        predictions, gt_json, verbose=args.verbose,
        caption=not args.no_caption, detection=not args.no_detection,
        densecap=not args.no_densecap, rotated_boxes=args.rotated_boxes,
        device=device)
    out_path = os.path.join(os.path.dirname(args.path), "eval_results.json")
    with open(out_path, "w") as f:
        json.dump(_plain(results), f, indent=2)
    print(f"results saved to {out_path}")
    return results


if __name__ == "__main__":
    main()
