"""The least time a kernel's work can take on the card, counted from each
call's inputs by plain code of the benchmark, never from a kernel's
outputs, so that any implementation of a site is held to the same work.

A bound is the larger of the bytes over the peak bandwidth and the
operations over the float32 peak (the H100 SXM data sheet's 3.35 TB/s and
67 TFLOP/s); ``share_pct`` sets the bounds of the profiled steps' calls
against the device time of the kernels that served them."""

from __future__ import annotations

from typing import Iterable

from h100bench.harness import PEAK_BYTES, PEAK_F32_FLOPS
from h100bench.trace import kernels


def bound_s(nbytes: float, ops: float) -> float:
    return max(nbytes / PEAK_BYTES, ops / PEAK_F32_FLOPS)


def share_pct(reading, names: Iterable[str], bounds_s: float):
    """100 x the calls' summed bound over the summed device time of the
    kernels whose name holds one of ``names``, launched in the profiled
    steps; None where the trace holds none."""
    names = tuple(names)
    device_s = sum(o.end - o.ts for o in kernels(reading.trace.in_steps())
                   if any(n in o.name for n in names)) / 1e6
    if device_s <= 0 or bounds_s <= 0:
        return None
    return 100.0 * bounds_s / device_s
