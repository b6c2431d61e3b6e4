"""Idle ms per train step in the gaps that end with an operation launched
inside the time of the program's ``scan2cap.backward`` span, on any
thread: the autograd engine launches the backward's kernels from its own
device threads (``h100bench/program_spans.py``)."""

from h100bench.program_spans import idle_ms


def read(r):
    return idle_ms(r, "scan2cap.backward", any_thread=True)
