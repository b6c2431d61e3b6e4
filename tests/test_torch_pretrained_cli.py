"""The pretrained track's entry points in process on the CPU, at
``SCAN2CAP_TEST_TINY`` sizes on the CLI fixture (``tests/test_torch_cli.py``):
MaskVoteNet -> ``extract_gt_features`` (train and val) -> ``train_pretrained``
(gt) with an in-training eval -> ``eval_pretrained``; a detector ->
``extract_votenet_features`` -> ``train_pretrained`` and ``eval_pretrained``
in votenet mode; the unported ``--mesh`` and the card as the default device.
These are the entry-point cases of ``tests/test_torch_pretrained.py``, in a
file of their own so that the run's workers share the two files' time."""

import json

import numpy as np
import pytest

from tests.test_torch_cli import write_cli_data

from scan2cap_torch.data.feature_store import open_feature_store
from scan2cap_torch.models.capnet_pretrained import CapNetPretrained
from scan2cap_torch.scripts import (eval_pretrained as evalcli,
                                    extract_gt_features,
                                    extract_votenet_features,
                                    train as traincli,
                                    train_maskvotenet as mvncli,
                                    train_pretrained as precli)
from scan2cap_torch.train.checkpoints import CheckpointIO


# --- the entry points -------------------------------------------------------
TINY = ["--batch_size", "2", "--verbose", "1", "--device", "cpu"]
PRE_FLAGS = ["--use_topdown", "--use_relation", "--num_graph_steps", "2",
             "--num_locals", "2", "--use_orientation"]


@pytest.fixture
def cli_env(tmp_path, monkeypatch):
    data = write_cli_data(tmp_path, np.random.RandomState(0))
    monkeypatch.setenv("SCAN2CAP_DATA", str(data))
    monkeypatch.setenv("SCAN2CAP_OUTPUT", str(tmp_path / "outputs"))
    monkeypatch.setenv("SCAN2CAP_TEST_TINY", "1")
    return data, tmp_path / "outputs"


def _run(outputs, tag):
    return next(p for p in outputs.iterdir() if p.name.endswith(tag))


def test_gt_track_extract_train_eval(cli_env, capsys):
    data, outputs = cli_env
    mvncli.main(TINY + ["--num_points", "2048", "--use_normal", "--epoch",
                        "1", "--tag", "mvn"])
    mvn = _run(outputs, "_MVN").name
    stats = extract_gt_features.main(["--folder", mvn, "--split", "train",
                                      "--epoch", "2"] + TINY[:2] + TINY[4:])
    assert stats["batches"] == 4 and stats["samples"] == 8   # 4 pairs x 2
    extract_gt_features.main(["--folder", mvn, "--split", "val"]
                             + TINY[:2] + TINY[4:])
    with open_feature_store(str(data / "gt_ScanRefer_features_train.npz")) \
            as db:
        keys = set(db.keys())
        for e in range(2):
            for s in ("scene0000_00", "scene0001_00"):
                for suffix in ("_gt_ids", "_features", "_bbox_corners",
                               "_gt_corners"):
                    assert f"{e}|{s}{suffix}" in keys
        feats = db["1|scene0000_00_features"]
        assert feats.shape == (2, 128) and feats.dtype == np.float32
        assert db["0|scene0000_00_gt_ids"].dtype == np.int64
    assert len(keys) == 16

    capsys.readouterr()
    solver = precli.main(TINY + PRE_FLAGS + ["--mode", "gt", "--epoch", "1",
                                             "--val_step", "2", "--tag",
                                             "pre"])
    run = _run(outputs, "_PRE")
    info = json.loads((run / "info.json").read_text())
    assert info["device"] == "cpu" and info["num_train"] == 4
    log = (run / "log.txt").read_text()
    assert "[eval @ iter 2]" in log and "loss" in log
    for name in ("best", "last", "resume"):
        assert (run / "ckpt" / f"{name}.pt").exists()
    assert solver.state.step == 2
    last = CheckpointIO(str(run / "ckpt")).restore("last")["model"]
    model = CapNetPretrained(solver.model.cfg, "gt", solver.model.caption
                             .num_vocabs, device="cpu", seed=9)
    model.load_state_dict(last, strict=True)

    capsys.readouterr()
    res = evalcli.main(["--folder", run.name, "--batch_size", "2",
                        "--device", "cpu"])
    out = capsys.readouterr().out
    for tag in ("[BLEU-4]", "[CIDEr]", "[ROUGE]", "[METEOR]"):
        assert tag in out, out
    assert np.isfinite(res["cider"])
    # the val scene's two objects, by their stored ids
    assert {k for k in res["candidates"] if "eos" not in k} >= {
        "scene0001_00|0|chair", "scene0001_00|1|chair"}
    stats = json.loads((run / "eval_stats.json").read_text())
    assert stats["caption"]["batches"] == 1


def test_votenet_track_extract_train_eval(cli_env):
    data, outputs = cli_env
    traincli.main(TINY + ["--num_points", "512", "--num_proposals", "16",
                          "--epoch", "1", "--no_caption", "--tag", "det"])
    det = _run(outputs, "_DET").name
    for split in ("train", "val"):
        stats = extract_votenet_features.main(
            ["--folder", det, "--split", split] + TINY[:2] + TINY[4:])
        assert stats["batches"] == 1
    with open_feature_store(
            str(data / "votenet_ScanRefer_predictions_train.npz")) as db:
        for s in ("scene0000_00", "scene0001_00"):
            for suffix in ("_object_ids", "_features", "_bbox_corners",
                           "_gt_ids", "_gt_corners"):
                assert f"0|{s}{suffix}" in db
            assert db[f"0|{s}_gt_corners"].shape == (3, 8, 3)
            assert db[f"0|{s}_features"].shape[1:] == (128,)
    precli.main(TINY + ["--mode", "votenet", "--use_topdown", "--epoch", "1",
                        "--val_step", "2", "--tag", "prevn"])
    run = _run(outputs, "_PREVN")
    assert "[eval @ iter 2]" in (run / "log.txt").read_text()
    res = evalcli.main(["--folder", run.name, "--batch_size", "2",
                        "--min_iou", "0.0", "--device", "cpu"])
    assert np.isfinite(res["cider"])


def test_pretrained_entry_points_refuse_mesh_and_default_to_the_card(
        cli_env):
    # once refused: --mesh 2,1 trains over two ranks (gloo), its first
    # loss the one process's within 2e-3
    data, outputs = cli_env
    mvncli.main(TINY + ["--num_points", "2048", "--use_normal", "--epoch",
                        "1", "--tag", "mvn"])
    extract_gt_features.main(["--folder", _run(outputs, "_MVN").name,
                              "--split", "train", "--epoch", "1"]
                             + TINY[:2] + TINY[4:])
    losses = {}
    for tag, extra in (("one", []), ("two", ["--mesh", "2,1"])):
        precli.main(TINY + PRE_FLAGS + ["--epoch", "1", "--tag", tag]
                    + extra)
        run = _run(outputs, "_" + tag.upper())
        assert json.loads((run / "info.json").read_text())["mesh"] == (
            extra[1] if extra else None)
        losses[tag] = json.loads((run / "train_stats.json").read_text())[
            "epochs"][0]["losses"][0]
    assert abs(losses["two"] - losses["one"]) <= 2e-3 * abs(losses["one"])
    assert precli.build_parser().parse_args([]).device == "cuda"
    assert evalcli.build_parser().parse_args(
        ["--folder", "x"]).device == "cuda"
    for cli in (extract_gt_features, extract_votenet_features):
        assert cli.build_parser().parse_args([]).device == "cuda"
        with pytest.raises(SystemExit, match="--folder"):
            cli.main(["--device", "cpu"])
    assert precli.val_features("/d/retrain/gt_x_train.npz") == \
        "/d/retrain/gt_x_val.npz"
