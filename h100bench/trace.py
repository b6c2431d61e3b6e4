"""Reading a ``torch.profiler`` Chrome trace: device operations, their
launches on the host, the benchmark's spans and the autograd engine's
functions.

A device operation is a kernel, a copy or a memset.  A kernel belongs to
a host span when its launch lies inside the span, on the span's thread.
Where the trace holds no launch record for a kernel (a runtime linked
into a library the profiler does not hook), the kernel takes the launch
time of the kernel before it on its stream, since a stream runs its
kernels in launch order.
"""

from __future__ import annotations

import bisect
import collections
import json
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
STEPS_SPAN = "h100bench.steps"
ENGINE = "autograd::engine::evaluate_function"


class Op:
    __slots__ = ("name", "cat", "ts", "end", "stream", "launch", "tid")

    def __init__(self, name, cat, ts, dur, stream):
        self.name, self.cat, self.ts, self.end = name, cat, ts, ts + dur
        self.stream = stream
        self.launch: Optional[float] = None
        self.tid = None


class Trace:
    """``ops``: device operations in start order, each with its launch
    time and thread; ``spans``: the host's user annotations; ``cpu_ops``:
    the host's operator events.  Times in microseconds."""

    def __init__(self, events: Iterable[Dict]):
        launches = {}
        self.ops: List[Op] = []
        self.spans: List[Tuple[str, float, float, object]] = []
        self.cpu_ops: List[Tuple[str, float, float, object]] = []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
            args = e.get("args") or {}
            if cat in DEVICE_CATS:
                op = Op(e["name"], cat, ts, dur, (e.get("pid"), e.get("tid")))
                op.launch = args.get("correlation")
                self.ops.append(op)
            elif cat in LAUNCH_CATS and "correlation" in args:
                launches[args["correlation"]] = (ts, e.get("tid"))
            elif cat == "user_annotation":
                self.spans.append((e["name"], ts, ts + dur, e.get("tid")))
            elif cat == "cpu_op":
                self.cpu_ops.append((e["name"], ts, ts + dur, e.get("tid")))
        self.ops.sort(key=lambda o: o.ts)
        last = {}
        for op in self.ops:
            found = launches.get(op.launch)
            if found is None:
                found = last.get(op.stream, (None, None))
            op.launch, op.tid = found
            last[op.stream] = found

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            return cls(json.load(f)["traceEvents"])

    def span(self, name: str) -> Tuple[float, float, object]:
        """The first span of that name: (start, end, thread)."""
        for n, ts, end, tid in self.spans:
            if n == name:
                return ts, end, tid
        raise KeyError(f"no span {name} in the trace")

    def steps(self) -> Tuple[float, float]:
        ts, end, _ = self.span(STEPS_SPAN)
        return ts, end

    def launched_in(self, intervals: Sequence[Tuple[float, float, object]],
                    ops: Optional[List[Op]] = None) -> List[Op]:
        """Device operations launched inside any of the (start, end,
        thread) intervals, on that thread."""
        by_tid = collections.defaultdict(list)
        for ts, end, tid in intervals:
            by_tid[tid].append((ts, end))
        starts = {}
        for tid, iv in by_tid.items():
            iv.sort()
            merged = []
            for ts, end in iv:
                if merged and ts <= merged[-1][1]:
                    merged[-1][1] = max(merged[-1][1], end)
                else:
                    merged.append([ts, end])
            by_tid[tid] = merged
            starts[tid] = [m[0] for m in merged]
        out = []
        for op in self.ops if ops is None else ops:
            iv = by_tid.get(op.tid)
            if op.launch is None or not iv:
                continue
            i = bisect.bisect_right(starts[op.tid], op.launch) - 1
            if i >= 0 and op.launch <= iv[i][1]:
                out.append(op)
        return out

    def in_steps(self) -> List[Op]:
        """Device operations launched between the start and the end of
        the profiled steps, on any thread."""
        lo, hi = self.steps()
        return [o for o in self.ops if o.launch is not None
                and lo <= o.launch <= hi]

    def spans_named(self, name: str) -> List[Tuple[float, float, object]]:
        return [(ts, end, tid) for n, ts, end, tid in self.spans if n == name]

    def engine_functions(self) -> List[Tuple[float, float, object]]:
        return [(ts, end, tid) for n, ts, end, tid in self.cpu_ops
                if n.startswith(ENGINE)]


def kernels(ops: Iterable[Op]) -> List[Op]:
    return [o for o in ops if o.cat == "kernel"]


def busy_us(ops: Iterable[Op], lo: float = float("-inf"),
            hi: float = float("inf")) -> float:
    """Length of the union of the operations' intervals, clipped to
    [lo, hi]."""
    total, cur_s, cur_e = 0.0, None, None
    for o in sorted(ops, key=lambda o: o.ts):
        s, e = max(o.ts, lo), min(o.end, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def top_ops(ops: Iterable[Op], n: int = 10) -> List[List]:
    """The ``n`` operation names that took most device time: [name,
    seconds]."""
    by = collections.Counter()
    for o in ops:
        by[o.name] += (o.end - o.ts) / 1e6
    return [[k, v] for k, v in by.most_common(n)]


def idle_gaps(trace: Trace, ops: Sequence[Op], n: int = 10) -> List[List]:
    """The device's idle time between the operations, by what the host
    was doing when it launched the operation that ended each gap: the
    innermost host operator around that launch, inside the benchmark's
    innermost span.  [label, seconds], the ``n`` largest."""
    ops = sorted(ops, key=lambda o: o.ts)
    cpu = collections.defaultdict(list)
    for name, ts, end, tid in trace.cpu_ops:
        cpu[tid].append((ts, end, name))
    spans = collections.defaultdict(list)
    for name, ts, end, tid in trace.spans:
        if name.startswith("h100bench.") and name != STEPS_SPAN:
            spans[tid].append((ts, end, name))

    for table in (cpu, spans):
        for rows in table.values():
            rows.sort()
    starts = {id(rows): [r[0] for r in rows]
              for table in (cpu, spans) for rows in table.values()}

    def innermost(table, tid, t):
        """The latest-starting entry that holds t (nested entries: the
        first one found walking back is the innermost)."""
        rows = table.get(tid)
        if not rows:
            return None
        i = bisect.bisect_right(starts[id(rows)], t) - 1
        for j in range(i, max(i - 256, -1), -1):
            if rows[j][1] >= t:
                return rows[j][2]
        return None

    by = collections.Counter()
    reach = None
    for o in ops:
        if reach is not None and o.ts > reach:
            label = innermost(cpu, o.tid, o.launch) if o.launch else None
            span = innermost(spans, o.tid, o.launch) if o.launch else None
            name = label or "no host operator"
            if span:
                name = f"{span[len('h100bench.'):]}: {name}"
            by[name] += (o.ts - reach) / 1e6
        reach = o.end if reach is None else max(reach, o.end)
    return [[k, v] for k, v in by.most_common(n)]
