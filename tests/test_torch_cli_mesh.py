"""The port's trainer and eval over a mesh, as a user runs them
(``python -m scan2cap_torch.scripts.train --mesh DATA,MODEL --device cpu``:
the entry point spawns the ranks, gloo, one torch thread each); mirrors
tests/test_cli_mesh.py on its fixture.

At (2, 2) the first-step loss is within 2e-3 relative (+1e-3) of one
process, the ``mesh:`` and ``vocab padded`` lines are printed, the
in-training eval fires, ``last`` and ``resume`` are written and info.json
records the mesh; ``--spatial`` on top keeps the bound; the mesh run
resumes under ``--mesh 2,2``; ``eval --mesh 2,2`` prints the scores of
``eval`` without it (the val set's one scene pads the data axis).  The
JAX test's (4, 2) run is the slow case.  ``setup_mesh`` and
``parse_mesh`` keep the JAX messages.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from tests.test_torch_cli import write_cli_data

from scan2cap_torch.parallel import mesh as pmesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TRAIN = [sys.executable, "-m", "scan2cap_torch.scripts.train",
         "--batch_size", "4", "--num_points", "512", "--num_proposals", "16",
         "--verbose", "1", "--val_step", "1", "--no_augment",
         "--use_topdown", "--num_locals", "4", "--device", "cpu"]
EVAL = [sys.executable, "-m", "scan2cap_torch.scripts.eval",
        "--eval_caption", "--min_iou", "-1", "--batch_size", "4",
        "--device", "cpu"]


def _env(root):
    env = dict(os.environ)
    env.update(SCAN2CAP_DATA=str(root / "data"),
               SCAN2CAP_OUTPUT=str(root / "outputs"),
               SCAN2CAP_TEST_TINY="1", PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return env


def _call(cmd, env):
    res = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=900, cwd=REPO)
    assert res.returncode == 0, (res.stdout[-2000:], res.stderr[-3000:])
    return res.stdout


def _run_dir(root, tag):
    return next(p for p in (root / "outputs").iterdir()
                if p.name.endswith("_" + tag.upper()))


def _first_loss(run):
    log = (run / "log.txt").read_text()
    m = re.search(r"\bloss ([0-9.]+) cap", log)
    assert m, log
    return float(m.group(1))


def _close(got, want):
    assert abs(got - want) <= 2e-3 * abs(want) + 1e-3, (got, want)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_mesh")
    write_cli_data(root, np.random.RandomState(0))
    env = _env(root)
    out = {"root": root, "env": env}
    _call(TRAIN + ["--epoch", "1", "--tag", "ref1"], env)
    out["mesh"] = _call(TRAIN + ["--epoch", "1", "--mesh", "2,2", "--tag",
                                 "mesh22"], env)
    out["spatial"] = _call(TRAIN + ["--epoch", "1", "--mesh", "2,2",
                                    "--spatial", "--tag", "spat22"], env)
    return out


def test_train_cli_mesh_matches_one_process(runs):
    root, stdout = runs["root"], runs["mesh"]
    assert "mesh: data=2 model=2 vocab padded" in stdout, stdout[-2000:]
    run = _run_dir(root, "mesh22")
    log = (run / "log.txt").read_text()
    assert "[eval @ iter" in log, log
    assert (run / "ckpt" / "last.pt").exists()
    assert (run / "ckpt" / "resume.pt").exists()
    info = json.loads((run / "info.json").read_text())
    assert info["mesh"] == "2,2" and info["num_vocabs_padded"] >= 128
    _close(_first_loss(run), _first_loss(_run_dir(root, "ref1")))


def test_train_cli_mesh_spatial_matches_one_process(runs):
    root = runs["root"]
    assert "spatial(SA query axis over model)" in runs["spatial"]
    _close(_first_loss(_run_dir(root, "spat22")),
           _first_loss(_run_dir(root, "ref1")))


def test_resume_cli_mesh(runs):
    root, env = runs["root"], runs["env"]
    stdout = _call(TRAIN + ["--epoch", "2", "--mesh", "2,2",
                            "--use_checkpoint", _run_dir(root, "mesh22").name,
                            "--tag", "meshres"], env)
    assert "resumed from" in stdout
    log = (_run_dir(root, "meshres") / "log.txt").read_text()
    assert "epoch 2 starting..." in log and "epoch 1 starting" not in log


def test_eval_cli_mesh_prints_the_one_process_scores(runs):
    root, env = runs["root"], runs["env"]
    folder = ["--folder", _run_dir(root, "mesh22").name]
    one = _call(EVAL + folder, env)
    mesh = _call(EVAL + folder + ["--mesh", "2,2"], env)
    assert "mesh: data=2 model=2" in mesh
    scores_1 = [l for l in one.splitlines() if l.startswith("[")]
    scores_m = [l for l in mesh.splitlines() if l.startswith("[")]
    assert scores_1 and scores_1 == scores_m, (scores_1, scores_m)


@pytest.mark.slow
def test_train_and_eval_cli_mesh_4x2(tmp_path):
    write_cli_data(tmp_path, np.random.RandomState(0))
    env = _env(tmp_path)
    _call(TRAIN + ["--epoch", "1", "--tag", "ref1dev"], env)
    stdout = _call(TRAIN + ["--epoch", "1", "--mesh", "4,2", "--tag",
                            "mesh42"], env)
    assert "mesh: data=4 model=2" in stdout and "vocab padded" in stdout
    run = _run_dir(tmp_path, "mesh42")
    _close(_first_loss(run), _first_loss(_run_dir(tmp_path, "ref1dev")))
    stdout = _call(TRAIN + ["--epoch", "1", "--mesh", "4,2", "--spatial",
                            "--tag", "spat42"], env)
    _close(_first_loss(_run_dir(tmp_path, "spat42")),
           _first_loss(_run_dir(tmp_path, "ref1dev")))
    _call(TRAIN + ["--epoch", "2", "--mesh", "4,2", "--use_checkpoint",
                   run.name, "--tag", "meshres"], env)
    folder = ["--folder", run.name]
    one = _call(EVAL + folder, env)
    mesh = _call(EVAL + folder + ["--mesh", "4,2"], env)
    assert [l for l in one.splitlines() if l.startswith("[")] == \
        [l for l in mesh.splitlines() if l.startswith("[")]


def test_setup_mesh_validates_batch_divisibility():
    m = pmesh.setup_mesh("4,2", 8, device="cpu")
    assert m.shape == {"data": 4, "model": 2}
    with pytest.raises(SystemExit, match=r"--batch_size 2 must be "
                                         r"divisible by the mesh data "
                                         r"axis \(4\)"):
        pmesh.setup_mesh("4,1", 2, device="cpu")


def test_parse_mesh_rejects_bad_specs():
    with pytest.raises(ValueError, match="needs"):
        pmesh.parse_mesh("16,2", "cpu")       # 32 devices of 8
    with pytest.raises(ValueError):
        pmesh.parse_mesh("0,4", "cpu")
    with pytest.raises(ValueError):
        pmesh.parse_mesh("2,2,2", "cpu")
    assert pmesh.parse_mesh("8", "cpu").shape == {"data": 8, "model": 1}
    with pytest.raises(ValueError, match=r"--mesh 2,1 needs 2 devices; "
                                         r"only 1 available \(cuda\)"):
        pmesh.parse_mesh("2,1", "cuda", n_devices=1)
    with pytest.raises(SystemExit, match="needs 2 devices"):
        pmesh.setup_mesh("2,1", 8, "cuda", n_devices=1)
