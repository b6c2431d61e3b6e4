"""Idle ms per train step in the gaps that end with an operation launched
inside the program's ``scan2cap.match`` span (the Hungarian matching: its
cost matrices, their copy to the host, the assignments' copy back), on
its thread (``h100bench/program_spans.py``)."""

from h100bench.program_spans import idle_ms


def read(r):
    return idle_ms(r, "scan2cap.match")
