"""Tracing, timing and a numerics guard (counterpart of
``scan2cap_tpu/utils/profiling.py``).

* ``trace(logdir)``: ``torch.profiler`` around a block (the host, and the
  card where there is one), written to ``<logdir>/trace.json`` as a Chrome
  trace, the file ``scripts/profile_report.py`` reads; ``start`` and
  ``stop`` are its two halves, which the trainers' ``--profile`` calls
  across steps (``train/solver.py``);
* ``annotate(name)``: a named span in that trace (``record_function``);
* ``StepTimer``: named phase durations on the host's clock, their means;
* ``check_finite(tensors)``: raise on NaN or Inf in a dict or list of
  tensors (one host read per tensor: call it sparingly).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import numpy as np
import torch


def start(device: torch.device) -> torch.profiler.profile:
    """A running profiler of the host, and of the card on a CUDA
    ``device``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.__enter__()
    return prof


def stop(prof: torch.profiler.profile, logdir: str) -> None:
    """Stop ``prof`` once the card's work is done and write
    ``<logdir>/trace.json``."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    prof = start(torch.device("cuda" if torch.cuda.is_available()
                              else "cpu"))
    try:
        yield prof
    finally:
        stop(prof, logdir)


def annotate(name: str):
    return torch.profiler.record_function(name)


class StepTimer:
    """Accumulates named phase durations; reports means."""

    def __init__(self):
        self.times: Dict[str, list] = defaultdict(list)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times[name].append(time.perf_counter() - t0)

    def mean(self, name: str, last: Optional[int] = None) -> float:
        xs = self.times[name]
        if not xs:
            return 0.0
        return float(np.mean(xs[-last:] if last else xs))

    def report(self, last: Optional[int] = None) -> Dict[str, float]:
        return {k: self.mean(k, last) for k in self.times}


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def check_finite(tree, name: str = "tree") -> None:
    """Raise ``FloatingPointError`` if a floating tensor or array of
    ``tree`` (nested dicts, lists and tuples) holds a NaN or an Inf."""
    bad = []
    for path, leaf in _leaves(tree):
        if torch.is_tensor(leaf):
            if leaf.is_floating_point() and not bool(
                    torch.isfinite(leaf).all()):
                bad.append(path)
        elif isinstance(leaf, np.ndarray) and leaf.dtype.kind == "f":
            if not np.isfinite(leaf).all():
                bad.append(path)
    if bad:
        raise FloatingPointError(f"non-finite values in {name}: {bad[:10]}")
