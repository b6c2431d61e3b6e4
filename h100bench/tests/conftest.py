"""The benchmark's CPU tests: ``python -m pytest h100bench/tests -q`` from
the root of the repository.  Tests that need the card carry the ``cuda``
marker and decide inside a fixture."""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; skips without one")


@pytest.fixture(autouse=True)
def few_threads():
    """One run of a tiny cell per test: four torch threads at most."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
