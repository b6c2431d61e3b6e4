"""Run one cell of ``BENCHMARK.json`` once.

    python3 -m h100bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the port (``scan2cap_torch``): it
loads the cell's configuration and traffic, makes the weights and the
input pool on the card from the seed, warms the cell's shapes, measures
for ``--seconds`` (with ``--trace 1`` a fixed number of steps of the
window under the profiler), checks what the timed path produced against
the plain reference in ``h100bench/reference``, and prints one JSON line
last on standard output.  Without a card, or with fewer cards than the
cell asks for, it exits 2 and prints no result.  It exits 3 if a module of
JAX or of the JAX package is loaded when the window has closed.
"""

from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch
    from h100bench import harness
    bench = harness.load_json("BENCHMARK.json")
    cell = harness.Cell.load(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    path = importlib.import_module(f"h100bench.paths.{cell.traffic['path']}")
    result = path.run(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), START)
    found = harness.forbidden_modules(sys.modules)
    if found:
        print(f"modules of JAX or of the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    harness.report_checks(result["checks"])
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
