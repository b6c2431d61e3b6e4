"""BENCHMARK.json and the files it names parse and keep the contract's
characters; every cell's files and every per-layer reader are there."""

import json
import os
import re

import pytest

from h100bench import harness
from h100bench.tests.tiny import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys_and_paths():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["h100bench"]
    assert 1 <= b["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w for w in b["command"])
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_uniqueness():
    b = bench()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in b[group]]
        assert len(names) == len(set(names)), group
        assert all(NAME.match(n) for n in names), names
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for w in b["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_cell_files_parse(cell):
    here = os.getcwd()
    os.chdir(ROOT)
    try:
        c = harness.Cell.load(bench(), cell)
    finally:
        os.chdir(here)
    assert c.traffic["path"] in ("serve", "train")
    assert os.path.exists(os.path.join(ROOT, "h100bench", "paths",
                                       c.traffic["path"] + ".py"))
    if c.traffic["path"] == "serve":
        assert set(c.limits) == {"answer_gap"}
    else:
        assert {"first_loss_gap", "grad_gap", "change_gap"} <= set(c.limits)
        assert set(c.limits) <= {"first_loss_gap", "loss_gap_2", "loss_gap_3",
                                 "grad_gap", "change_gap", "worst_change_gap"}
    assert c.config["matmul_precision"] == "float32"
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in reported


def test_every_per_layer_metric_has_its_reader():
    for m in bench()["per_layer"]:
        assert callable(harness.reader(m["name"])), m["name"]


def test_configs_are_used_and_reduced_names_no_width():
    b = bench()
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}
    for c in b["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        for k in c["reduced"]:
            assert not k.endswith(("_dim", "_rank", "_size")), k
            assert k in cfg
