"""No run may hold JAX or the JAX package; the reference imports nothing
of the program."""

import ast
import os

import pytest

from h100bench import harness
from h100bench.tests.tiny import ROOT


@pytest.mark.parametrize("name", ["jax", "jax.numpy", "jaxlib", "flax.linen",
                                  "optax", "scan2cap_tpu", "scan2cap_tpu.x"])
def test_forbidden_top_level_names_are_found(name):
    assert harness.forbidden_modules([name, "torch"]) == [name]


@pytest.mark.parametrize("name", ["scan2cap_torch", "scan2cap_torch.ops",
                                  "jaxtyping", "flaxen", "numpy"])
def test_other_top_level_names_pass(name):
    assert harness.forbidden_modules([name]) == []


def imports_of(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(ROOT, "h100bench", "reference")
    for name in os.listdir(ref):
        if name.endswith(".py"):
            tops = {m.split(".")[0] for m in imports_of(os.path.join(ref, name))}
            assert not tops & {"scan2cap_torch", "scan2cap_tpu", "jax",
                               "jaxlib", "flax", "optax"}, name


def test_no_file_of_the_benchmark_imports_jax():
    for base, _, files in os.walk(os.path.join(ROOT, "h100bench")):
        for name in files:
            if name.endswith(".py"):
                tops = {m.split(".")[0]
                        for m in imports_of(os.path.join(base, name))}
                assert not tops & set(harness.FORBIDDEN), name
