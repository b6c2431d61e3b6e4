"""``backward_ms.train``'s reading, of Vote2Cap-DETR's train step."""

from h100bench.harness import reader

read = reader("backward_ms.train")
