"""The runner that the side-by-side timing scripts of this directory share
(``large_shapes.py``, ``pack_times.py``).  Each times the kernels of any
checkout of this repository, so that two designs can be set side by side on
one card, one after the other in one command.

A script supplies ``run()``, which imports what it times from
``scan2cap_torch`` inside the call and returns ``{"rows": [...], ...}``
(each row a dict with an ``equal`` key: its result held against the same
checkout's plain version; and where a profiler trace may miss calls, a
``complete`` key), and ``show(row)``, one printed line a row.  This
module imports the package of the checkout named by ``--root``, checks that
it came from there, adds the card's name and power limit, prints the rows
and the result as one JSON line (appended to ``--json PATH`` too), and
exits 1 if a row differs or is incomplete.  It imports nothing of the
package itself, so that a script run as a file can time another checkout
than its own.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def import_checkout(root: str, script: str) -> None:
    """Put ``root`` first on the path and import its ``scan2cap_torch``."""
    sys.path.insert(0, root)
    import torch

    import scan2cap_torch

    if not torch.cuda.is_available():
        raise SystemExit(f"{script}: needs the card")
    package = os.path.dirname(os.path.abspath(scan2cap_torch.__file__))
    if os.path.dirname(package) != root:
        raise SystemExit(f"{script}: imported {package}, not {root}")


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()


def main(script_file: str, doc: str, run, show, argv=None) -> int:
    here = os.path.dirname(os.path.abspath(script_file))
    script = os.path.splitext(os.path.basename(script_file))[0]
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(here)),
                    help="the checkout whose kernels are timed")
    ap.add_argument("--json", metavar="PATH",
                    help="append the result there as one JSON line")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    import_checkout(root, script)
    result = dict(root=root, card=card(), **run())
    print(root, result["card"])
    for row in result["rows"]:
        print(show(row))
    line = json.dumps(result)
    if args.json:
        with open(args.json, "a") as f:
            f.write(line + "\n")
    print(line)
    ok = all(r["equal"] and r.get("complete", True) for r in result["rows"])
    return 0 if ok else 1
