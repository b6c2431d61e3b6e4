"""Timing on the card, shared by the probes and ``chip_smoke.py``.

``event_ms`` brackets back-to-back calls with two CUDA events, so it reads
the larger of the host's cost per call and the device's time; ``device_ms``
reads the kernels' own time from a ``torch.profiler`` trace of the same
loop, which leaves the host out.

A trace can lose a few of the first kernels it should hold (seen on an H100
with PyTorch 2.11 in a process that had profiled before: the first FPS and
ball-query launches of a train step were missing, at the level of the
profiler's raw events; sleeping under the profiler did not help, several
hundred launches ahead of the step did).  ``profile_calls`` therefore puts
``GUARD_LAUNCHES`` int16 fills, a kernel nothing else in the port launches,
ahead of the calls, leaves them out of what it returns, and profiles
again, behind twice as many, if the caller finds the trace incomplete.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

GUARD_LAUNCHES = 512
_GUARD_KERNEL = "FillFunctor<short>"
Rows = List[Tuple[float, str, int]]


def event_ms(fn: Callable[[], object], iters: int, warmup: int = 1) -> float:
    """Mean time of ``fn()`` over ``iters`` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def trace_kernels(prof) -> Rows:
    """(device ms, name, launches) of every kernel in a profiler trace."""
    rows = []
    for e in prof.key_averages():
        if "CUDA" not in str(e.device_type):     # kernels, not the CPU ops
            continue
        if e.key.startswith("Optimizer."):       # PyTorch's own annotation of
            continue                             # a span on the device
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            rows.append((dev_us / 1e3, e.key, e.count))
    return rows


def profile_calls(fn: Callable[[], object], calls: int = 1, cpu: bool = False,
                  complete: Optional[Callable[[Rows], bool]] = None,
                  attempts: int = 3) -> Dict:
    """``calls`` calls of ``fn()`` under a fresh profiler on an idle card.

    Returns ``rows`` (the trace's kernels without the guard launches),
    ``wall_ms`` of the calls (host clock, ended by a synchronize),
    ``attempts`` (profiler passes made) and ``complete``: the result of
    ``complete(rows)`` for the last pass; the calls are profiled again, up
    to ``attempts`` times, while that is false."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    guard = torch.zeros(8, dtype=torch.int16, device="cuda")
    for attempt in range(1, attempts + 1):
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            for _ in range(GUARD_LAUNCHES << (attempt - 1)):
                guard.fill_(0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        rows = [r for r in trace_kernels(prof) if _GUARD_KERNEL not in r[1]]
        ok = True if complete is None else bool(complete(rows))
        if ok:
            break
    return dict(rows=rows, wall_ms=wall_ms, attempts=attempt, complete=ok)


def device_ms(fn: Callable[[], object], iters: int, warmup: int = 1
              ) -> Dict[str, float]:
    """Device time per call of ``fn()`` from a profiler trace of ``iters``
    calls: ``ms`` is the summed time of all kernels over ``iters``,
    ``launches`` the kernels per call; ``complete`` says that the trace
    holds a whole number of kernels per call."""
    for _ in range(warmup):
        fn()

    def whole(rows: Rows) -> bool:
        n = sum(r[2] for r in rows)
        return n > 0 and n % iters == 0

    r = profile_calls(fn, calls=iters, complete=whole)
    return dict(ms=sum(x[0] for x in r["rows"]) / iters,
                launches=sum(x[2] for x in r["rows"]) / iters,
                complete=r["complete"], attempts=r["attempts"])
