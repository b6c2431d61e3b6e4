"""Cells of the benchmark at a size a CPU test holds: the committed
configuration and traffic files with their sizes cut, every width kept
in proportion."""

from __future__ import annotations

import copy
import os

from h100bench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SIZES = dict(num_points=2048, sa_npoints=[256, 128, 64, 32])
CAPNET = dict(SIZES, num_proposals=32, hidden_size=64, emb_size=32,
              num_vocabs=40, min_iou=0.0)
POOL = dict(batch=2, pool=4, warmup=1, checked_requests=2)


def cell(name: str, **traffic) -> harness.Cell:
    """The committed cell ``name`` at the tiny size."""
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    here = os.getcwd()
    os.chdir(ROOT)
    try:
        c = harness.Cell.load(bench, name)
    finally:
        os.chdir(here)
    c = copy.deepcopy(c)
    c.config.update(CAPNET if c.config["kind"] == "capnet" else SIZES)
    c.traffic.update(POOL, **traffic)
    return c
