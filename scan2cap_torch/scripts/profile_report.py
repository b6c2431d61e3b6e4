"""The top operations of a ``torch.profiler`` trace by summed time:
``python -m scan2cap_torch.scripts.profile_report --trace <run>/profile``
(counterpart of ``scripts/profile_report.py``).

Reads the Chrome trace that the trainers' ``--profile N`` writes
(``<run>/profile/trace.json``) or ``utils/profiling.trace`` writes (both
through ``utils/profiling.stop``), with the standard library alone, and
sums each event name's duration in a category: by default the card's kernels
(``kernel``; a trace taken on the CPU has none, and then the host's
operations, ``cpu_op``, are ranked), or ``--cat`` another (``gpu_memcpy``,
``user_annotation``...).

Run: python -m scan2cap_torch.scripts.profile_report --trace DIR_OR_FILE \\
        [--top 25] [--cat kernel]
"""

from __future__ import annotations

import argparse
import json
import os
from collections import defaultdict


def _events(path: str):
    if os.path.isdir(path):
        path = os.path.join(path, "trace.json")
    if not os.path.exists(path):
        raise SystemExit(f"no trace.json at {path}")
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def summarize(trace: str, top: int = 25, cat: str = "kernel"):
    """Rows (name, total ms, count, share of the category's time) of the
    ``top`` names by summed duration; prints the table."""
    events = [e for e in _events(trace) if e.get("ph") == "X"]
    chosen = [e for e in events if e.get("cat") == cat]
    if not chosen and cat == "kernel":     # a trace of the CPU alone
        cat = "cpu_op"
        chosen = [e for e in events if e.get("cat") == cat]
    agg = defaultdict(lambda: [0.0, 0])
    for e in chosen:
        a = agg[e["name"]]
        a[0] += float(e.get("dur", 0.0))             # microseconds
        a[1] += 1
    total = sum(v[0] for v in agg.values()) or 1.0
    ranked = sorted(agg.items(), key=lambda kv: -kv[1][0])[:top]
    print(f"== {cat}  (sum of event time {total / 1e3:.3f} ms over "
          f"{len(chosen)} events)")
    print(f"{'op':60s} {'total ms':>10s} {'count':>8s} {'%':>6s}")
    rows = []
    for name, (us, cnt) in ranked:
        print(f"{name[:60]:60s} {us / 1e3:10.3f} {cnt:8d} "
              f"{100.0 * us / total:6.1f}")
        rows.append((name, us / 1e3, cnt, us / total))
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--trace", type=str, required=True,
                   help="the profile directory (holding trace.json) or "
                        "the trace file")
    p.add_argument("--top", type=int, default=25)
    p.add_argument("--cat", type=str, default="kernel",
                   help="the event category to rank (default: kernel)")
    args = p.parse_args(argv)
    return summarize(args.trace, args.top, args.cat)


if __name__ == "__main__":
    main()
