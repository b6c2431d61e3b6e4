"""The port's launch recipes (``scan2cap_torch/launch/*.sh``) against the
JAX package's (``launch/*.sh``).

Each recipe is sourced by bash with ``python`` replaced by a function that
prints its arguments, so that the commands come out as bash expands them
(``"$1"``, ``${TAG:-...}``, ``${PRETRAINED:-...}``, ``${SCAN2CAP_DATA:-
data}``), with those variables unset and set.  The port's commands must
be the JAX recipe's, token for token, with ``python -m
scan2cap_torch.<dir>.<name>`` in place of ``python <dir>/<name>.py``, and
each must parse through its entry point's own ``build_parser()``.
"""

import importlib
import os
import subprocess

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPES = ("train_full", "eval_full", "benchmark",
           "extract_and_train_pretrained", "train_maskvotenet")
SET = dict(TAG="my_tag", PRETRAINED="released/model.pth",
           SCAN2CAP_DATA="/data/scannet")
# prints each call's arguments, NUL-separated, one call a line
STUB = 'python() { printf "%s\\0" "$@"; printf "\\n"; }; source "$0" RUN_1'


def _port(name):
    return os.path.join(ROOT, "scan2cap_torch", "launch", f"{name}.sh")


def _jax(name):
    return os.path.join(ROOT, "launch", f"{name}.sh")


def _calls(path, env_set):
    env = {k: v for k, v in os.environ.items() if k not in SET}
    if env_set:
        env.update(SET)
    out = subprocess.run(["bash", "-c", STUB, path], env=env, check=True,
                         capture_output=True, text=True, timeout=60).stdout
    return [line.split("\0")[:-1] for line in out.splitlines()]


def _as_jax(argv):
    """``-m scan2cap_torch.scripts.train ...`` -> ``scripts/train.py ...``."""
    assert argv[0] == "-m" and argv[1].startswith("scan2cap_torch."), argv
    return [argv[1][len("scan2cap_torch."):].replace(".", "/") + ".py",
            *argv[2:]]


@pytest.mark.parametrize("name", RECIPES)
def test_recipe_passes_bash_n(name):
    subprocess.run(["bash", "-n", _port(name)], check=True, timeout=60)
    with open(_port(name)) as f:
        text = f.read()
    assert text.startswith("#!/usr/bin/env bash\n")
    assert "set -euo pipefail" in text
    assert os.access(_port(name), os.X_OK)


@pytest.mark.parametrize("env_set", [False, True], ids=["defaults", "set"])
@pytest.mark.parametrize("name", RECIPES)
def test_recipe_is_the_jax_recipe_through_the_ports_parsers(name, env_set):
    port, jax = _calls(_port(name), env_set), _calls(_jax(name), env_set)
    assert port and len(port) == len(jax)
    for argv, want in zip(port, jax):
        assert _as_jax(argv) == want
        module = importlib.import_module(argv[1])
        args = module.build_parser().parse_args(argv[2:])
        assert getattr(args, "device", "cuda") == "cuda"
        if "--tag" in argv:
            assert args.tag == (SET["TAG"] if env_set else
                                argv[argv.index("--tag") + 1])
