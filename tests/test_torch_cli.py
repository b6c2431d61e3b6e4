"""The port's entry points end to end on the CPU: train -> resume -> eval ->
predict, called in process with ``--device cpu`` on generated fixture data
(two tiny scenes in the ScanNet layout, ScanRefer JSON, a GloVe pickle) at
the ``SCAN2CAP_TEST_TINY`` sizes.  Mirrors tests/test_cli_end_to_end.py for
the JAX CLIs: the run's info.json, log.txt and checkpoint triad, an
in-training eval, a resume that runs only the second epoch and numbers it
globally, the seven caption metrics and mAP/AR at 0.25 and 0.5, and one
pred.json entry per benchmark scene.
"""

import json
import pickle
import re

import numpy as np
import pytest
import torch

from tests.test_dataset import make_fixture_glove, make_fixture_scene

from scan2cap_torch import convert
from scan2cap_torch.benchmark import predict
from scan2cap_torch.scripts import eval as evalcli
from scan2cap_torch.scripts import train as traincli
from scan2cap_torch.train.checkpoints import CheckpointIO

TINY = ["--batch_size", "2", "--num_points", "512", "--num_proposals", "16",
        "--verbose", "1", "--device", "cpu"]
FLAGS = ["--use_topdown", "--num_locals", "4", "--num_graph_steps", "2",
         "--use_relation", "--use_orientation"]


def write_cli_data(root, rng):
    """The data layout the CLIs read (tests/test_cli_end_to_end.py:17-54),
    plus the rotations file --use_orientation reads."""
    data = root / "data"
    scannet = data / "scannet" / "scannet_data"
    scannet.mkdir(parents=True)
    scenes = ["scene0000_00", "scene0001_00"]
    for s in scenes:
        make_fixture_scene(str(scannet), s, rng, n_points=1500)
    words = ["this", "is", "a", "red", "chair", "big", "table"]
    with open(data / "glove.p", "wb") as f:
        pickle.dump(make_fixture_glove(words), f)

    def entries(scene_ids):
        return [{"scene_id": s, "object_id": str(obj), "object_name": "chair",
                 "ann_id": "0", "token": ["this", "is", "a", "red", "chair"],
                 "description": "this is a red chair"}
                for s in scene_ids for obj in range(2)]

    with open(data / "ScanRefer_filtered_train.json", "w") as f:
        json.dump(entries(scenes), f)
    with open(data / "ScanRefer_filtered_val.json", "w") as f:
        json.dump(entries(scenes[1:]), f)
    organized = {}
    for e in entries(scenes):
        organized.setdefault(e["scene_id"], {}).setdefault(
            e["object_id"], {})[e["ann_id"]] = e
    with open(data / "ScanRefer_filtered_organized.json", "w") as f:
        json.dump(organized, f)
    rot = {s: {str(o): np.eye(3).tolist() for o in range(3)} for s in scenes}
    with open(data / "scannet_instance_rotations.json", "w") as f:
        json.dump(rot, f)
    return data


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one thread: the tiny models gain nothing from more, and
    idle threads spinning on cores that other test workers share make the
    file many times dearer."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def cli_env(tmp_path, monkeypatch):
    data = write_cli_data(tmp_path, np.random.RandomState(0))
    monkeypatch.setenv("SCAN2CAP_DATA", str(data))
    monkeypatch.setenv("SCAN2CAP_OUTPUT", str(tmp_path / "outputs"))
    monkeypatch.setenv("SCAN2CAP_TEST_TINY", "1")
    return tmp_path / "outputs"


def _run(outputs, tag):
    return next(p for p in outputs.iterdir() if p.name.endswith(tag))


def test_train_resume_eval_predict(cli_env, capsys):
    # epoch 1: 4 samples at B=2 are 2 steps; the eval fires at step 2
    traincli.main(TINY + FLAGS + ["--epoch", "1", "--val_step", "2",
                                  "--profile", "1", "--tag", "a"])
    run_a = _run(cli_env, "_A")
    info = json.loads((run_a / "info.json").read_text())
    assert info["device"] == "cpu" and info["num_train"] == 4
    assert info["num_eval_val"] == 1 and info["num_vocabs_padded"] == 0
    log = (run_a / "log.txt").read_text()
    assert "epoch 1 starting..." in log and "loss" in log
    assert "[eval @ iter 2]" in log, log
    assert (run_a / "profile" / "trace.json").exists()
    for name in ("best", "last", "resume"):
        assert (run_a / "ckpt" / f"{name}.pt").exists(), name
    assert not list((run_a / "ckpt").glob("*.new"))
    resume_a = CheckpointIO(str(run_a / "ckpt")).restore("resume")
    assert resume_a["epoch"] == 0 and resume_a["step"] == 2
    assert json.loads((run_a / "scalars.json").read_text())["train/loss"]
    stats = json.loads((run_a / "train_stats.json").read_text())
    assert stats["steps"] == 2 and len(stats["save_s"]) == 1
    assert len(stats["epochs"][0]["step_s"]) == 2
    assert all(np.isfinite(stats["epochs"][0]["losses"]))

    # resume: only epoch 2 runs, numbered globally
    capsys.readouterr()
    traincli.main(TINY + FLAGS + ["--epoch", "2", "--val_step", "100",
                                  "--use_checkpoint", run_a.name,
                                  "--tag", "b"])
    assert f"resumed from {run_a.name} at epoch 1" in capsys.readouterr().out
    run_b = _run(cli_env, "_B")
    log = (run_b / "log.txt").read_text()
    assert "epoch 2 starting..." in log
    assert "epoch 1 starting..." not in log and log.count("starting...") == 1
    resume_b = CheckpointIO(str(run_b / "ckpt")).restore("resume")
    assert resume_b["epoch"] == 1 and resume_b["step"] == 4
    steps = {int(s["step"]) for s in
             resume_b["optimizer"]["state"].values()}
    assert steps == {4}                      # the optimizer's count went on

    # last.pt loads into a fresh model bit-equal, and through the
    # reference's layout too
    last = CheckpointIO(str(run_b / "ckpt")).restore("last")["model"]
    ref = convert.reference_from_state_dict(last)
    back = convert.state_dict_from_reference(ref)
    assert set(back) == set(last)
    assert all(torch.equal(back[k], last[k]) for k in last)

    # eval: the seven caption metrics and mAP / AR at 0.25 and 0.5
    capsys.readouterr()
    res = evalcli.main(["--folder", run_b.name, "--eval_caption",
                        "--eval_detection", "--batch_size", "2",
                        "--device", "cpu"])
    out = capsys.readouterr().out
    for tag in ("[BLEU-1]", "[BLEU-2]", "[BLEU-3]", "[BLEU-4]", "[CIDEr]",
                "[ROUGE]", "[METEOR]", "mAP@0.25", "AR@0.25", "mAP@0.5",
                "AR@0.5"):
        assert tag in out, (tag, out)
    assert set(res["detection"]) == {0.25, 0.5}
    assert np.isfinite(res["caption"]["cider"])
    stats = json.loads((run_b / "eval_stats.json").read_text())
    assert stats["caption"]["batches"] == stats["detection"]["batches"] == 1

    # predict: one entry per scene*_00 of the split
    preds = predict.main(["--folder", run_b.name, "--batch_size", "2",
                          "--device", "cpu"])
    saved = json.loads((run_b / "pred.json").read_text())
    assert set(saved) == set(preds) == {"scene0001_00"}
    assert json.loads((run_b / "predict_stats.json").read_text())[
        "predict"]["batches"] == 1
    for entry in saved["scene0001_00"]:
        assert len(entry["box"]) == 8 and len(entry["sem_prob"]) == 18
        assert len(entry["obj_prob"]) == 2 and isinstance(entry["caption"],
                                                          str)


def _first_loss(run):
    log = (run / "log.txt").read_text()
    return float(re.search(r"\bloss ([0-9.]+) cap", log).group(1))


@pytest.mark.parametrize("flag", [["--mesh", "2,1"], ["--spatial"]])
def test_unported_flags_exit_with_their_message(cli_env, flag):
    # once refused: --mesh runs the epoch over two ranks (gloo) and
    # records the mesh; --spatial alone stops with the JAX message
    if flag == ["--spatial"]:
        with pytest.raises(SystemExit, match="--spatial requires --mesh"):
            traincli.main(TINY + ["--epoch", "1"] + flag)
        return
    traincli.main(TINY + ["--epoch", "1", "--no_caption", "--tag", "one"])
    traincli.main(TINY + ["--epoch", "1", "--no_caption", "--tag", "two"]
                  + flag)
    run = _run(cli_env, "_TWO")
    info = json.loads((run / "info.json").read_text())
    assert info["mesh"] == "2,1" and info["num_vocabs_padded"] == 0
    assert (run / "ckpt" / "last.pt").exists()
    want, got = _first_loss(_run(cli_env, "_ONE")), _first_loss(run)
    assert abs(got - want) <= 2e-3 * abs(want), (got, want)
    assert traincli.build_parser().parse_args([]).device == "cuda"


def test_bf16_run_trains_and_is_rebuilt_in_bfloat16(cli_env):
    # --bf16 (once refused) trains, info.json keeps it, and the entry
    # points that read the run rebuild the bfloat16 model
    solver = traincli.main(TINY + ["--epoch", "1", "--no_caption", "--bf16",
                                   "--tag", "bf"])
    model = solver.state.model
    assert model.cfg.compute_dtype == "bfloat16"
    assert model.backbone_net.sa2.mlp.compute_dtype == torch.bfloat16
    run = _run(cli_env, "_BF")
    info = json.loads((run / "info.json").read_text())
    assert info["bf16"] is True
    assert traincli.model_config_from_info(info).compute_dtype == "bfloat16"
    stats = json.loads((run / "train_stats.json").read_text())
    assert all(np.isfinite(stats["epochs"][0]["losses"]))
    res = evalcli.main(["--folder", run.name, "--eval_detection",
                        "--batch_size", "2", "--device", "cpu"])
    assert set(res["detection"]) == {0.25, 0.5}


def test_entry_points_default_to_the_card(cli_env):
    assert traincli.build_parser().parse_args([]).device == "cuda"
    assert evalcli.build_parser().parse_args(
        ["--folder", "x"]).device == "cuda"
    assert predict.build_parser().parse_args(
        ["--folder", "x"]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            traincli.main(["--epoch", "1"])


def test_eval_refuses_caption_eval_of_detection_weights(cli_env, tmp_path):
    traincli.main(TINY + ["--epoch", "1", "--no_caption", "--tag", "det"])
    run = _run(cli_env, "_DET")
    model_sd = CheckpointIO(str(run / "ckpt")).restore("last")["model"]
    pth = tmp_path / "votenet.pth"
    torch.save(convert.reference_from_state_dict(model_sd), pth)
    with pytest.raises(SystemExit, match="detection weights only"):
        evalcli.main(["--folder", run.name, "--eval_caption",
                      "--use_pretrained", str(pth), "--device", "cpu"])
    res = evalcli.main(["--folder", run.name, "--eval_detection",
                        "--use_pretrained", str(pth), "--batch_size", "2",
                        "--device", "cpu"])
    assert set(res["detection"]) == {0.25, 0.5}
