"""The readings that the limits of ``h100bench/limits/<cell>.json`` are set
from, at the cell's own sizes, several seeds in one process:

    python3 -m h100bench.control --workload <name> --seeds 1,2,3 [--json PATH]

For each seed it prints one JSON line with what the ``readings`` of the
cell's path module (``paths/<path>.py``) returns: ``program``, the
check's numbers of the program (the lower readings); ``control``, those
of the reference computed with its products' inputs rounded to TF32, the
nearest precision below the configuration's float32, put in the
program's place (the upper readings); and whatever faults the path plants
in the reference put in the program's place.  The benchmark's own runs do
not run this.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys

import torch

from h100bench import harness


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--json")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = harness.Cell.load(harness.load_json("BENCHMARK.json"),
                             args.workload)
    harness.set_precision(cell.config)
    path = importlib.import_module(f"h100bench.paths.{cell.traffic['path']}")
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        row = dict(workload=cell.name, seed=seed,
                   **path.readings(cell, seed, device))
        print(json.dumps(row), flush=True)
        rows.append(row)
        torch.cuda.empty_cache()
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
