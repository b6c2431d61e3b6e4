"""ETA formatting (copy of ``scan2cap_tpu/utils/eta.py``; utils/eta.py:6-33
of the reference)."""

from __future__ import annotations


def decode_eta(seconds: float) -> dict:
    seconds = max(0, int(seconds))
    return {
        "h": seconds // 3600,
        "m": (seconds % 3600) // 60,
        "s": seconds % 60,
    }


def format_eta(seconds: float) -> str:
    e = decode_eta(seconds)
    return f"{e['h']}h {e['m']}m {e['s']}s"
