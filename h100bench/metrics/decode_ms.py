"""Device ms per request or train step of the operations launched inside
the program's ``scan2cap.decode`` span (a caption decoder's loop over its
steps), on its thread."""

from h100bench.program_spans import device_ms


def read(r):
    return device_ms(r, "scan2cap.decode")
