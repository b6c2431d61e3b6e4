"""``ScanRefer_filtered_organized.json``:
``python -m scan2cap_torch.scripts.organize_scanrefer`` (counterpart of
``scripts/organize_scanrefer.py``).

Nests ``<data>/ScanRefer_filtered.json`` as scene -> object -> annotation
and writes it beside the input.

Run: python -m scan2cap_torch.scripts.organize_scanrefer [--data <dir>]
"""

from __future__ import annotations

import argparse
import json
import os

from scan2cap_torch.config import PathConfig


def organize(entries):
    """scene_id -> object_id -> ann_id -> entry."""
    organized = {}
    for e in entries:
        organized.setdefault(e["scene_id"], {}) \
            .setdefault(e["object_id"], {})[e["ann_id"]] = e
    return organized


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--data", type=str, default=PathConfig().data)
    args = p.parse_args(argv)
    src = os.path.join(args.data, "ScanRefer_filtered.json")
    with open(src) as f:
        scanrefer = json.load(f)
    out = os.path.join(args.data, "ScanRefer_filtered_organized.json")
    with open(out, "w") as f:
        json.dump(organize(scanrefer), f, indent=4)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
