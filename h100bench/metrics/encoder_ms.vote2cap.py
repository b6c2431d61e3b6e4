"""Device ms per train step of the operations launched inside the
program's ``scan2cap.encoder`` span (Vote2Cap-DETR's pre-encoder, masked
encoder and projection, forward), on its thread."""

from h100bench.program_spans import device_ms


def read(r):
    return device_ms(r, "scan2cap.encoder")
