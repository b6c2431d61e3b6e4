"""Command-line entry points of the port: ``python -m scan2cap_torch.scripts.train``
and ``python -m scan2cap_torch.scripts.eval``."""
