"""What the readers of the program's own spans share.

The port opens ``scan2cap.*`` spans through
``scan2cap_torch/utils/profiling.annotate`` while a profiler runs: one
``scan2cap.step`` a request or train step, the model's stages,
``scan2cap.decode`` (a caption decoder's loop), ``scan2cap.loss``,
``scan2cap.backward`` and ``scan2cap.optimizer``.  A program without them
(an older checkout) leaves the readers nothing to read: they return None.

An idle gap is the one ``trace.idle_gaps`` counts: with the profiled
steps' device operations in start order, the time from the latest end of
every earlier operation to the start of the next one.  A gap belongs to a
span when the operation that ends it was launched inside that span: on
the span's own thread, or, for a span whose work other threads launch
(the autograd engine launches the backward's kernels from its own device
threads), at any time inside it on any thread.
"""

from __future__ import annotations

from typing import Optional, Tuple


def _mine(r, span: str, any_thread: bool) -> Optional[Tuple[list, list]]:
    """(the profiled steps' operations, those launched inside ``span``),
    or None where the trace has no device operation or no such span."""
    ops = r.trace.in_steps()
    intervals = r.trace.spans_named(span)
    if not ops or not intervals:
        return None
    if any_thread:
        tids = {o.tid for o in ops}
        intervals = [(ts, end, tid) for ts, end, _ in intervals
                     for tid in tids]
    return ops, r.trace.launched_in(intervals, ops)


def device_ms(r, span: str) -> Optional[float]:
    """Device ms a profiled step of the operations launched inside
    ``span``, on its thread."""
    found = _mine(r, span, False)
    if found is None:
        return None
    return sum(o.end - o.ts for o in found[1]) / 1e3 / r.steps


def idle_ms(r, span: str, any_thread: bool = False) -> Optional[float]:
    """Idle ms a profiled step in the gaps that belong to ``span``."""
    found = _mine(r, span, any_thread)
    if found is None:
        return None
    ops, mine = found
    mine = {id(o) for o in mine}
    total, reach = 0.0, None
    for o in sorted(ops, key=lambda o: o.ts):
        if reach is not None and o.ts > reach and id(o) in mine:
            total += o.ts - reach
        reach = o.end if reach is None else max(reach, o.end)
    return total / 1e3 / r.steps
