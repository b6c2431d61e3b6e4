"""ReferIt3D (Nr3D) annotations in the ScanRefer layout:
``python -m scan2cap_torch.scripts.organize_referit3d`` (counterpart of
``scripts/organize_referit3d.py``).

Reads the Nr3D CSV and writes ``<data>/nr3d_organized.json`` (scene ->
object -> annotation) and, with both split lists, the flat
``ReferIt3D_filtered_{train,val}.json``.

The JAX script reads the CSV with pandas; this one needs only the standard
library: ``csv`` for the records (quoted fields with commas, quotes and
line breaks) and ``ast.literal_eval`` for the token lists.  Each column is
typed as ``pandas.read_csv`` types it (all integers -> int, integers with a
missing value or any decimal -> float, True/False -> bool, else text, a
missing text -> NaN), so the JSON written is the JAX script's byte for byte.

Run: python -m scan2cap_torch.scripts.organize_referit3d --csv nr3d.csv \\
        [--data <dir>] [--train_scenes scannetv2_train.txt \\
        --val_scenes scannetv2_val.txt]
"""

from __future__ import annotations

import argparse
import csv
import json
import math
import os
from ast import literal_eval
from typing import Dict, List

from scan2cap_torch.config import PathConfig

# pandas.read_csv's default missing-value strings
NA_VALUES = frozenset((
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"))
_TRUE, _FALSE = ("True", "TRUE", "true"), ("False", "FALSE", "false")


def _parses(parse, text: str) -> bool:
    try:
        parse(text)
    except ValueError:
        return False
    return True


def typed_column(texts: List[str]) -> list:
    """One CSV column's cells as ``pandas.read_csv`` types them."""
    present = [t for t in texts if t not in NA_VALUES]
    missing = len(present) < len(texts)
    if present and all(_parses(int, t) for t in present):
        if not missing:
            return [int(t) for t in texts]
        return [math.nan if t in NA_VALUES else float(int(t)) for t in texts]
    if present and all(_parses(float, t) for t in present):
        return [math.nan if t in NA_VALUES else float(t) for t in texts]
    if (present and not missing
            and all(t in _TRUE or t in _FALSE for t in present)):
        return [t in _TRUE for t in texts]
    return [math.nan if t in NA_VALUES else t for t in texts]


def read_csv_columns(csv_path: str) -> Dict[str, list]:
    """Header -> typed column, read with the ``csv`` module."""
    with open(csv_path, newline="") as f:
        rows = list(csv.reader(f))
    header, body = rows[0], [r for r in rows[1:] if r]
    return {name: typed_column([r[i] if i < len(r) else "" for r in body])
            for i, name in enumerate(header)}


def parse_rows(csv_path: str) -> List[Dict]:
    cols = read_csv_columns(csv_path)
    entries = []
    for i in range(len(cols["scan_id"])):
        entries.append({
            "scene_id": cols["scan_id"][i],
            "object_id": str(cols["target_id"][i]),
            "object_name": cols["instance_type"][i],
            "ann_id": str(cols["assignmentid"][i]),
            "description": str(cols["utterance"][i]).lower(),
            "token": literal_eval(cols["tokens"][i]),
        })
    return entries


def organize(entries):
    """scene_id -> object_id -> ann_id -> entry."""
    organized = {}
    for e in entries:
        organized.setdefault(e["scene_id"], {}) \
            .setdefault(e["object_id"], {})[e["ann_id"]] = e
    return organized


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--csv", type=str, required=True, help="nr3d.csv")
    p.add_argument("--data", type=str, default=PathConfig().data)
    p.add_argument("--train_scenes", type=str, default=None,
                   help="scannetv2_train.txt (for the split)")
    p.add_argument("--val_scenes", type=str, default=None)
    args = p.parse_args(argv)

    entries = parse_rows(args.csv)
    with open(os.path.join(args.data, "nr3d_organized.json"), "w") as f:
        json.dump(organize(entries), f, indent=4)

    if args.train_scenes and args.val_scenes:
        with open(args.train_scenes) as f:
            train = {line.strip() for line in f}
        with open(args.val_scenes) as f:
            val = {line.strip() for line in f}
        for split, scenes in (("train", train), ("val", val)):
            part = [e for e in entries if e["scene_id"] in scenes]
            out = os.path.join(args.data, f"ReferIt3D_filtered_{split}.json")
            with open(out, "w") as f:
                json.dump(part, f, indent=4)
            print(f"{split}: {len(part)} annotations -> {out}")
    print(f"total: {len(entries)} annotations")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
