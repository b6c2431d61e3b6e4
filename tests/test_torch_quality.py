"""The training-quality trajectory of the port against the JAX package's.

* The committed card curve (``scan2cap_torch/measurements/
  quality_trajectory_h100.json``) is held to the JAX package's own gates:
  ``tests/test_quality_trajectory.py``'s artifact tests run on it
  unchanged (peak mAP@0.25 >= 0.2, final >= 0.15, peak train CIDEr >= 2.0,
  final >= 0.4, the final loss under half of step 50's, step 0's mAP below
  0.05, the flagship at 40,000 points and 256 proposals, 600 steps), and it
  must come from the card at the JAX artifact's settings.
* The record functions (``eval_detection``, ``eval_cider``) against the JAX
  script's logic (``scripts/quality_trajectory.py:151-191``, its closures
  written out here over the JAX package's functions) at the script's tiny
  size, on the same weights and batches, at step 0 and after 2 of the
  port's steps: mAP, AR and CIDEr within 1e-6.
* The entry points' flags: the unported ones stop, ``--seeds`` needs a
  ``{seed}`` placeholder, the card is the default device.
"""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import tests.test_quality_trajectory as jax_gates

from scan2cap_tpu.config import Config
from scan2cap_tpu.config import ModelConfig as JModelConfig
from scan2cap_tpu.data.synthetic import stage_scene_batch
from scan2cap_tpu.eval.ap_helper import (
    APCalculator, assemble_pred_map_cls, parse_groundtruths,
    parse_predictions_device)
from scan2cap_tpu.eval.capeval import Cider
from scan2cap_tpu.eval.eval_helper import decode_caption, postprocess_scene_cap
from scan2cap_tpu.models import CapNet as JCapNet
from scan2cap_tpu.train import make_eval_step as jmake_eval_step
from scan2cap_tpu.train.step import TrainState as JTrainState

from scan2cap_torch.convert import flax_from_state_dict
from scan2cap_torch.data.synthetic import (make_scene_batch, make_vocab,
                                           to_device)
from scan2cap_torch.models import CapNet
from scan2cap_torch.scripts import demo_synthetic_train as demo
from scan2cap_torch.scripts import quality_trajectory as qt
from scan2cap_torch.train.step import (create_train_state, make_eval_step,
                                       make_train_step)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CURVE = os.path.join(REPO, "scan2cap_torch", "measurements",
                     "quality_trajectory_h100.json")
CURVE_BF16S = os.path.join(REPO, "scan2cap_torch", "measurements",
                           "quality_trajectory_bf16s_h100.json")
STUDY = os.path.join(REPO, "scan2cap_torch", "measurements", "quality_study")


def test_card_curve_meets_the_jax_package_bounds(monkeypatch):
    monkeypatch.setattr(jax_gates, "ARTIFACT", CURVE)
    jax_gates.test_artifact_is_flagship_full_scale()
    jax_gates.test_artifact_quality_bounds()
    with open(CURVE) as f:
        art = json.load(f)
    c = art["config"]
    # the JAX artifact's settings, on the card
    assert (c["eval_batches"], c["seed"], c["steps"], c["batch_size"],
            c["num_batches"], c["lr"]) == (4, 42, 600, 8, 4, 1e-3)
    assert art["curve"]["step"] == list(range(0, 601, 50))
    assert art["platform"] == "cuda" and art["card"].startswith("NVIDIA")
    assert art["launches_per_step"] == dict(furthest_point_sample_cuda=5.0,
                                            ball_query_cuda=5.0,
                                            group_points_cuda=6.0)


def test_bf16_storage_curve_meets_the_jax_package_bounds(monkeypatch):
    # --bf16_storage on the card, held to the same gates, unloosened
    monkeypatch.setattr(jax_gates, "ARTIFACT", CURVE_BF16S)
    jax_gates.test_artifact_is_flagship_full_scale()
    jax_gates.test_artifact_quality_bounds()
    with open(CURVE_BF16S) as f:
        art = json.load(f)
    c = art["config"]
    assert c["storage_dtype"] == "bfloat16"
    assert (c["eval_batches"], c["seed"], c["steps"], c["batch_size"],
            c["num_batches"], c["lr"]) == (4, 42, 600, 8, 4, 1e-3)
    assert art["curve"]["step"] == list(range(0, 601, 50))
    assert art["platform"] == "cuda" and art["card"].startswith("NVIDIA")
    assert art["launches_per_step"] == dict(furthest_point_sample_cuda=5.0,
                                            ball_query_cuda=5.0,
                                            group_points_cuda=6.0)


def test_analyze_quality_study_on_the_jax_tests_cases(monkeypatch,
                                                      tmp_path):
    # tests/test_analyze_quality_study.py's synthetic cases, each branch of
    # the pre-registered rule, through the port's copy
    import tests.test_analyze_quality_study as jstudy
    monkeypatch.setattr(jstudy, "SCRIPT", os.path.join(
        REPO, "scan2cap_torch", "scripts", "analyze_quality_study.py"))
    for i, case in enumerate((jstudy.test_neutral_study_flips_default,
                              jstudy.test_collapse_and_regression_stay_opt_in,
                              jstudy.test_cap_acc_guard)):
        (tmp_path / str(i)).mkdir()
        case(tmp_path / str(i))


def test_analyze_quality_study_equals_the_jax_script(tmp_path):
    import subprocess
    import sys

    from tests.test_analyze_quality_study import _write_run
    for d in ("port", "jax"):
        (tmp_path / d).mkdir()
        for seed, f32, bf in ((1, 0.40, 0.41), (2, 0.42, 0.37),
                              (3, 0.38, 0.40)):
            _write_run(str(tmp_path / d), seed, "f32", f32)
            _write_run(str(tmp_path / d), seed, "bf16s", bf, 0.95)
    outs = []
    for d, script in (("port", ["-m", "scan2cap_torch.scripts."
                                "analyze_quality_study"]),
                      ("jax", [os.path.join(REPO, "scripts",
                                            "analyze_quality_study.py")])):
        res = subprocess.run([sys.executable, *script, "--dir",
                              str(tmp_path / d)], cwd=REPO, check=True,
                             capture_output=True, text=True, timeout=120)
        outs.append(res.stdout.replace(str(tmp_path / d), "DIR"))
    assert outs[0] == outs[1]
    assert ((tmp_path / "port" / "paired_summary.json").read_bytes()
            == (tmp_path / "jax" / "paired_summary.json").read_bytes())


def test_committed_seed_study(tmp_path):
    # the card's six curves (seeds 42 to 44, float32 and bf16 storage) and
    # the verdict the port's analysis gives them
    from scan2cap_torch.scripts import analyze_quality_study as study
    import shutil
    names = sorted(n for n in os.listdir(STUDY) if n.startswith("qt_seed"))
    assert names == [f"qt_seed{s}_{a}.json" for s in (42, 43, 44)
                     for a in ("bf16s", "f32")]
    for n in names:
        with open(os.path.join(STUDY, n)) as f:
            art = json.load(f)
        assert art["platform"] == "cuda" and art["config"]["steps"] == 600
        assert art["config"].get("storage_dtype", "float32") == (
            "bfloat16" if "bf16s" in n else "float32")
        shutil.copy(os.path.join(STUDY, n), tmp_path / n)
    with open(CURVE_BF16S) as f, open(os.path.join(
            STUDY, "qt_seed42_bf16s.json")) as g:
        assert json.load(f) == json.load(g)
    summary = study.main(["--dir", str(tmp_path)])
    with open(os.path.join(STUDY, "paired_summary.json")) as f:
        assert json.load(f) == json.loads(json.dumps(summary))


# --- the record functions against the JAX script's logic ------------------
V = qt.NUM_VOCABS
ARGS = ["--tiny", "--num_points", "512", "--batch_size", "2", "--device",
        "cpu"]


def _jax_records(eval_step, post_fn, state, jpairs, train_pairs, idx2word):
    """scripts/quality_trajectory.py's eval_detection and eval_cider."""
    calc = APCalculator(0.25)
    for jb, hb in jpairs:
        out = eval_step(state, jb)
        parsed = jax.device_get(parse_predictions_device(
            {**out, "point_clouds": jb["point_clouds"]}))
        preds = assemble_pred_map_cls(np.asarray(out["bbox_corner"]), parsed)
        calc.step(preds, parse_groundtruths(hb))
    m = calc.compute_metrics()
    corpus, cands = {}, {}
    for bi, (jb, hb) in enumerate(train_pairs):
        out = eval_step(state, jb)
        post = post_fn(out, jb)
        keep = np.asarray(post["keep"])
        det = np.asarray(post["detected_object_ids"])
        ious = np.asarray(post["ious"])
        caps = np.asarray(post["captions"])
        for b in range(keep.shape[0]):
            oid = int(hb["object_id"][b])
            key = f"batch{bi}|scene{b}|{oid}"
            corpus[key] = [decode_caption(hb["lang_ids"][b], idx2word)]
            cand, best = "sos eos", -1.0
            for k in np.where(keep[b])[0]:
                if int(det[b, k]) == oid and ious[b, k] > best:
                    best = float(ious[b, k])
                    cand = decode_caption(caps[b, k], idx2word)
            cands[key] = [cand]
    return (float(m["mAP"]), float(m["AR"]),
            float(Cider().compute_score(corpus, cands)[0]))


@pytest.fixture
def one_torch_thread():
    """torch on one thread: the tiny model gains nothing from more, and
    while a run's workers share the cores, idle threads spinning on them
    made this file many times dearer."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_record_functions_match_the_jax_script(one_torch_thread):
    args = qt.build_parser().parse_args(ARGS)
    cfg = qt.make_config(args)
    jcfg = JModelConfig(**{f: getattr(cfg, f) for f in (
        "num_points", "num_proposals", "sa_npoints", "max_num_obj",
        "num_locals", "num_graph_steps", "use_topdown", "use_relation",
        "use_orientation", "min_iou")})
    vocab = make_vocab(num_vocabs=V, emb_size=cfg.emb_size)
    hosts = [make_scene_batch(cfg, batch_size=2, num_objects=6, vocab=vocab,
                              seed=s) for s in range(2)]
    train_pairs = [(to_device(hosts[0], "cpu"), hosts[0])]
    eval_pairs = [(to_device(hosts[1], "cpu"), hosts[1])]
    jbatches = [stage_scene_batch(h, jcfg) for h in hosts]

    model = CapNet(cfg, num_vocabs=V, device="cpu", seed=args.seed)
    # votes near the objects and boxes of the mean size at the votes, so
    # that step 0's detection records are not zeros
    with torch.no_grad():
        model.vgen.conv3.weight.mul_(0.02)
        model.proposal.conv3.weight.zero_()
    jeval_step = jmake_eval_step(Config(model=jcfg), JCapNet(jcfg,
                                                            num_vocabs=V))
    post_fn = jax.jit(
        lambda out, batch: postprocess_scene_cap(out, batch, min_iou=0.25))
    eval_step = make_eval_step(cfg, model)
    step = make_train_step(cfg, create_train_state(cfg, model),
                           detection=True, caption=True, orientation=True)
    records = []
    for steps in (0, 2):
        for _ in range(steps):
            step(train_pairs[0][0], args.lr, 0.1)
        params, stats = flax_from_state_dict(model.state_dict())
        state = JTrainState(step=jnp.zeros((), jnp.int32),
                            params=jax.tree.map(jnp.asarray, params),
                            batch_stats=jax.tree.map(jnp.asarray, stats),
                            opt_state=(), tx=None)
        want = _jax_records(jeval_step, post_fn, state,
                            [(jbatches[1], hosts[1])],
                            [(jbatches[0], hosts[0])], vocab["idx2word"])
        got = (*qt.eval_detection(eval_step, eval_pairs),
               qt.eval_cider(eval_step, train_pairs, vocab["idx2word"]))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6,
                                   err_msg=f"after {steps} steps")
        records.append(got)
    # the detection records are not all zeros
    assert max(r[1] for r in records) > 0, records


def test_entry_points_refuse_the_unported_flags(tmp_path, monkeypatch, capfd,
                                               one_torch_thread):
    # once refused: --mesh 2,1 takes the step over two ranks (gloo), its
    # loss the one process's within 2e-3
    losses = {}
    for tag, extra in (("one", []), ("two", ["--mesh", "2,1"])):
        out = tmp_path / f"{tag}.json"
        assert qt.main(ARGS + ["--steps", "1", "--eval_every", "1",
                               "--num_batches", "1", "--out", str(out)]
                       + extra) == 0
        art = json.loads(out.read_text())
        assert art["config"]["mesh"] == (extra[1] if extra else None)
        losses[tag] = art["curve"]["loss"][1]
    assert abs(losses["two"] - losses["one"]) <= 2e-3 * abs(losses["one"])
    monkeypatch.setenv("SCAN2CAP_TEST_TINY", "1")
    demo_losses = {}
    for tag, extra in (("one", []), ("two", ["--mesh", "2,1"])):
        capfd.readouterr()
        with pytest.raises(SystemExit, match="loss did not decrease"):
            demo.main(["--device", "cpu", "--steps", "1", "--batch_size",
                       "2", "--num_points", "512", "--num_batches", "1"]
                      + extra)
        line = next(l for l in capfd.readouterr().out.splitlines()
                    if l.startswith('{"demo"'))
        demo_losses[tag] = json.loads(line)["demo"]["first"]["loss"]
    assert abs(demo_losses["two"] - demo_losses["one"]) <= \
        2e-3 * abs(demo_losses["one"])
    with pytest.raises(SystemExit):
        qt.parse_args(ARGS + ["--seeds", "1,2", "--out", "x.json"])
    assert qt.build_parser().parse_args([]).device == "cuda"
    assert demo.build_parser().parse_args([]).device == "cuda"


def test_bf16_flags_run(tmp_path, monkeypatch, capsys, one_torch_thread):
    # the flags once refused: a storage-narrowed trajectory and a
    # compute-narrowed demo with one component, each a few tiny steps
    out = tmp_path / "qt.json"
    assert qt.main(ARGS + ["--bf16_storage", "--steps", "2", "--eval_every",
                           "1", "--num_batches", "1", "--out",
                           str(out)]) == 0
    art = json.loads(out.read_text())
    assert art["config"]["storage_dtype"] == "bfloat16"
    assert art["curve"]["step"] == [0, 1, 2]
    assert all(np.isfinite(art["curve"]["loss"][1:]))
    monkeypatch.setenv("SCAN2CAP_TEST_TINY", "1")
    capsys.readouterr()
    try:
        demo.main(["--device", "cpu", "--bf16", "--bf16_components", "sa1",
                   "--steps", "2", "--batch_size", "2", "--num_points",
                   "512", "--num_batches", "1"])
    except SystemExit as e:             # the milestone check after 2 steps
        assert str(e) in ("loss did not decrease", "mAP is zero"), e
    line = next(l for l in capsys.readouterr().out.splitlines()
                if l.startswith('{"demo"'))
    run = json.loads(line)["demo"]
    assert (run["compute_dtype"], run["bf16_components"]) == ("bfloat16",
                                                              "sa1")
    assert run["steps"] == 2 and np.isfinite(run["last"]["loss"])
