"""Idle ms per request or train step in the gaps that end with an
operation launched inside the program's ``scan2cap.decode`` span, on its
thread (``h100bench/program_spans.py``)."""

from h100bench.program_spans import idle_ms


def read(r):
    return idle_ms(r, "scan2cap.decode")
