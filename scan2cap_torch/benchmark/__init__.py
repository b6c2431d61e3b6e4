"""Benchmark prediction of the port: ``python -m scan2cap_torch.benchmark.predict``."""
