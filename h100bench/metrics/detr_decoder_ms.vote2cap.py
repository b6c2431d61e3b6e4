"""Device ms per train step of the operations launched inside the
program's ``scan2cap.detr_decoder`` span (Vote2Cap-DETR's vote queries,
8 decoder layers and box heads, forward), on its thread."""

from h100bench.program_spans import device_ms


def read(r):
    return device_ms(r, "scan2cap.detr_decoder")
