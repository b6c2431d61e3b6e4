"""Two runs of the program against each other and against the reference
over a training cell's compared steps, at the cell's own sizes:

    python3 -m h100bench.repeat --workload <name> --seeds 1,2,3 [--deterministic] [--json PATH]

For each seed the program is built twice from the seed (runs A and B) and
takes the compared steps, and the reference takes them once.  One JSON
line a seed gives the check's numbers (``train.compare``) of A and of B
against the reference and of B against A, and by step how many calls of
FPS and of the first-k returned other indices (``picks``: calls parted,
indices parted) between A and B and between A and the reference.  With
``--deterministic`` the process runs under
``torch.use_deterministic_algorithms`` (atomic scatter-adds such as
``index_add_`` summed in a fixed order).  It shows whether a gap that
the check reads is the program's own from run to run, and at which step
the picks part.  The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
from typing import Dict, List

import torch

from h100bench import harness
from h100bench.paths import train
from h100bench.reference import ops as ref_ops


@contextlib.contextmanager
def recorded(module, names, out: List[torch.Tensor]):
    """While open, each index tensor that ``module.<name>`` returns is
    copied to the host into ``out``, call by call."""
    saved = {n: getattr(module, n) for n in names}

    def wrap(f):
        def g(*a, **kw):
            r = f(*a, **kw)
            out.append(r.detach().to("cpu", copy=True))
            return r
        return g

    for n, f in saved.items():
        setattr(module, n, wrap(f))
    try:
        yield out
    finally:
        for n, f in saved.items():
            setattr(module, n, f)


def program_run(cell, seed, device):
    from scan2cap_torch.ops import grouping, sampling
    model, state, step, pool = train.build(cell, seed, device)
    picks = []
    # the kernels' wrappers on the card, their plain versions elsewhere
    with recorded(sampling, ["furthest_point_sample_cuda",
                             "furthest_point_sample_plain"], picks), \
            recorded(grouping, ["ball_query_cuda", "ball_query_plain"],
                     picks):
        got = train.first_steps(model, state, step, pool, cell.traffic)
    kept = pool[:cell.traffic["checked_steps"]]
    del model, state, step, pool
    torch.cuda.empty_cache()
    return got, picks, kept


def parting(a: List[torch.Tensor], b: List[torch.Tensor],
            steps: int) -> List[List[int]]:
    """By step: the calls whose indices differ, and the indices that do."""
    if len(a) != len(b) or len(a) % steps:
        return [[-1, -1]] * steps
    per = len(a) // steps
    out = []
    for s in range(steps):
        calls = entries = 0
        for x, y in zip(a[s * per:(s + 1) * per], b[s * per:(s + 1) * per]):
            n = int((x.long() != y.long()).sum()) if x.shape == y.shape \
                else x.numel()
            calls += n > 0
            entries += n
        out.append([calls, entries])
    return out


def repeat(cell, seed, device) -> Dict:
    steps = cell.traffic["checked_steps"]
    a, picks_a, kept = program_run(cell, seed, device)
    b, picks_b, _ = program_run(cell, seed, device)
    picks_r = []
    with recorded(ref_ops, ["furthest_point_sample", "ball_query"], picks_r):
        want = train.reference_steps(cell, seed, kept, device)
    return dict(
        losses=dict(a=a["losses"], b=b["losses"], reference=want["losses"]),
        a_vs_reference=train.compare(a, want),
        b_vs_reference=train.compare(b, want),
        b_vs_a=train.compare(b, a, want["raw_grad"]),
        picks=dict(b_vs_a=parting(picks_a, picks_b, steps),
                   a_vs_reference=parting(picks_a, picks_r, steps)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--deterministic", action="store_true")
    p.add_argument("--json")
    args = p.parse_args(argv)
    if args.deterministic:
        # cuBLAS reads this when its first handle is made
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True, warn_only=True)
    if not torch.cuda.is_available():
        print("the repeat runs on the card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = harness.Cell.load(harness.load_json("BENCHMARK.json"),
                             args.workload)
    harness.set_precision(cell.config)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        row = dict(workload=cell.name, seed=seed,
                   deterministic=args.deterministic,
                   **repeat(cell, seed, device))
        print(json.dumps(row), flush=True)
        rows.append(row)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
