"""The pretrained track's scripts against the JAX package's, on the CPU:
the port's ``extract_gt_features`` against ``scripts/extract_gt_features.py``
on one MaskVoteNet ``.pth`` (keys, ids and corners exact, features 1e-4 of
their scale), and the smoke's in-process pretrained phase rehearsed in a
process that loads nothing of JAX.  Cases of ``tests/test_torch_pretrained.py``
in a file of their own so that the run's workers share the files' time."""

import importlib.util
import os
import sys

import h5py
import numpy as np
import torch

from tests.test_torch_pretrained import REPO, _close_to_scale
from tests.test_torch_pretrained_cli import TINY, _run, cli_env  # noqa: F401

from scan2cap_torch import convert
from scan2cap_torch.data.feature_store import open_feature_store
from scan2cap_torch.scripts import extract_gt_features
from scan2cap_torch.scripts import train_maskvotenet as mvncli
from scan2cap_torch.train.checkpoints import CheckpointIO


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_extract_gt_features_matches_the_jax_script(cli_env, monkeypatch):
    data, outputs = cli_env
    mvncli.main(TINY + ["--num_points", "512", "--use_normal", "--epoch",
                        "1", "--tag", "mvn"])
    last = CheckpointIO(str(_run(outputs, "_MVN") / "ckpt")).restore(
        "last")["model"]
    pth = str(data / "mask_votenet.pth")
    torch.save(convert.reference_from_state_dict(last), pth)
    flags = ["--pth", pth, "--split", "train", "--epoch", "2",
             "--batch_size", "2", "--num_points", "512", "--use_normal"]
    jax_out, port_out = str(data / "jax.hdf5"), str(data / "port.npz")
    monkeypatch.setattr(sys, "argv", ["extract_gt_features.py"] + flags
                        + ["--out", jax_out])
    jscript = _jax_script("extract_gt_features")
    jscript.extract(jscript.parse_args())
    extract_gt_features.main(flags + ["--out", port_out, "--device", "cpu"])
    with h5py.File(jax_out, "r") as jdb, open_feature_store(port_out) as db:
        assert set(db.keys()) == set(jdb.keys()) and len(db) == 16
        for k in jdb.keys():
            want, got = np.asarray(jdb[k]), db[k]
            assert got.dtype == want.dtype and got.shape == want.shape, k
            if k.endswith("_features"):
                _close_to_scale(got, want, 1e-4, k)
            else:
                np.testing.assert_array_equal(got, want, err_msg=k)


def test_smoke_pretrained_phase_rehearses_without_jax():
    # the smoke's in-process half of its pretrained phase on the CPU at a
    # small width, in a process that must load nothing of JAX
    import subprocess
    code = (
        "import sys, numpy as np, torch\n"
        "import chip_smoke as c\n"
        "sizes = dict(hidden_size=32, emb_size=16)\n"
        "t = c.train_pretrained_inprocess(torch, np, dev='cpu', sizes=sizes,"
        " B=2, num_vocabs=30, steps=2, windows=1)\n"
        "assert t['decode_tokens_equal_share'] == 1.0, t\n"
        "v = c.votenet_eval_inprocess(torch, np, dev='cpu', sizes=sizes, B=2,"
        " num_vocabs=30)\n"
        "assert v['candidates'] > 0, v\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'optax', 'scan2cap_tpu'))\n"
        "assert not bad, bad\n")
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO, timeout=300,
                         capture_output=True, text=True)
    assert run.returncode == 0, run.stderr[-3000:]
