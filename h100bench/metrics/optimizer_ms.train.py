"""Device ms per train step of the operations launched inside the
program's ``scan2cap.optimizer`` span (the fill of unreached gradients,
their sum over a mesh, the Adam update), on its thread."""

from h100bench.program_spans import device_ms


def read(r):
    return device_ms(r, "scan2cap.optimizer")
