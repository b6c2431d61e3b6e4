"""The port's offline benchmark scorer against the JAX package's, on the CPU.

* ``ops.boxes.generalized_box3d_iou_aabb`` / ``_rotated`` against the
  jitted JAX functions on seeded boxes, touching and disjoint pairs and
  z-rotations: 1e-6; the axis-aligned one in float64 (the default
  assignment's cost) against the JAX scorer's numpy copy: 1e-12;
* the delta corpus and the METEOR-shortfall calibration: equal;
* ``eval.benchmark.evaluate`` on ``tests/fixtures/benchmark_mini/`` against
  the JAX package's ``evaluate``, every key within 1e-9, on both
  assignment paths, and against the values ``tests/test_benchmark_fixture.py``
  pins (1e-6 where that file says so, else 1e-9);
* ``assign_pred_to_gt`` on both gIoU paths: equal candidates;
* ``scripts.build_benchmark_gt`` against ``scripts/build_benchmark_gt.py``
  on the CLI test fixture: equal;
* ``benchmark.eval`` in process, on the fixture and on empty predictions.
"""

import importlib.util
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests.test_torch_cli import write_cli_data

from scan2cap_tpu.eval import benchmark as jbenchmark
from scan2cap_tpu.eval.capeval import calibration as jcalibration
from scan2cap_tpu.eval.capeval import delta_corpus as jdelta_corpus
from scan2cap_tpu.ops import boxes as jboxes

from scan2cap_torch.benchmark import eval as evalcli
from scan2cap_torch.eval import benchmark
from scan2cap_torch.eval.capeval import calibration, delta_corpus
from scan2cap_torch.ops import boxes
from scan2cap_torch.scripts import build_benchmark_gt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MINI = os.path.join(REPO, "tests", "fixtures", "benchmark_mini")


def _rot_corners(center, size, heading):
    """z-up corners rotated about z, in the reference's corner order."""
    l, w, h = size
    sx = np.array([1, 1, -1, -1, 1, 1, -1, -1]) * l / 2
    sy = np.array([1, -1, -1, 1, 1, -1, -1, 1]) * w / 2
    sz = np.array([1, 1, 1, 1, -1, -1, -1, -1]) * h / 2
    c, s = np.cos(heading), np.sin(heading)
    return np.stack([c * sx + s * sy, -s * sx + c * sy, sz], 1) + center


def _boxes(rs, n, rotated):
    return np.stack([_rot_corners(rs.uniform(-2, 2, 3),
                                  rs.uniform(0.2, 2.0, 3),
                                  rs.uniform(-np.pi, np.pi) if rotated else 0.0)
                     for _ in range(n)]).astype(np.float32)


def _special_pairs():
    """A box against itself, a box touching it face to face, a disjoint
    one, one inside it, and the same rotated by 30 degrees about z (whose
    pairs the reference's axis-aligned footprint gate, from corners 1 and
    3, can zero)."""
    base = _rot_corners(np.zeros(3), np.array([2.0, 1.0, 1.5]), 0.0)
    others = [base,
              _rot_corners(np.array([2.0, 0.0, 0.0]),
                           np.array([2.0, 1.0, 1.5]), 0.0),      # touching
              _rot_corners(np.array([6.0, 5.0, 4.0]), np.ones(3), 0.0),
              _rot_corners(np.array([0.1, 0.1, 0.0]),
                           np.array([0.5, 0.5, 0.5]), 0.0),      # inside
              _rot_corners(np.zeros(3), np.array([2.0, 1.0, 1.5]),
                           np.pi / 6)]
    return (np.stack([base, others[4]]).astype(np.float32),
            np.stack(others).astype(np.float32))


@pytest.mark.parametrize("rotated", [False, True])
def test_giou_matches_jax(rotated):
    rs = np.random.RandomState(7 + rotated)
    sets = [(_boxes(rs, 9, rotated), _boxes(rs, 11, rotated)),
            _special_pairs()]
    for a, b in sets:
        for name in ("generalized_box3d_iou_aabb",
                     "generalized_box3d_iou_rotated"):
            want = np.asarray(jax.jit(getattr(jboxes, name))(a, b))
            got = getattr(boxes, name)(torch.from_numpy(a),
                                       torch.from_numpy(b))
            assert got.dtype == torch.float32 and got.shape == want.shape
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6,
                                       err_msg=name)
    a, b = _special_pairs()
    rot = boxes.generalized_box3d_iou_rotated(torch.from_numpy(a),
                                              torch.from_numpy(b)).numpy()
    assert rot[0, 0] == pytest.approx(1.0, abs=1e-5)      # itself
    assert rot[0, 1] <= 0 and rot[0, 2] < 0               # touching, apart


def test_giou_aabb_float64_matches_jax_scorer():
    # the default assignment's cost: the tensor gIoU in float64 against the
    # JAX scorer's numpy copy, on seeded, touching and disjoint boxes
    rs = np.random.RandomState(11)
    sets = [(_boxes(rs, 9, False), _boxes(rs, 11, False)), _special_pairs()]
    for a, b in sets:
        a, b = a.astype(np.float64), b.astype(np.float64)
        want = jbenchmark._giou_aabb_np(a, b)
        got = boxes.generalized_box3d_iou_aabb(torch.from_numpy(a),
                                               torch.from_numpy(b))
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)


def test_clip_convex_matches_jax():
    rs = np.random.RandomState(3)
    subject = _boxes(rs, 5, True)[:, (3, 2, 1, 0), :2]
    clip = _boxes(rs, 5, True)[:, (3, 2, 1, 0), :2]
    valid = np.ones((5, 4), bool)
    jv, jok = jax.jit(jboxes._clip_convex)(subject, valid, clip)
    tv, tok = boxes._clip_convex(torch.from_numpy(subject),
                                 torch.from_numpy(valid),
                                 torch.from_numpy(clip))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-6)


def test_delta_corpus_and_calibration_match_jax():
    assert delta_corpus.make_pairs(50, seed=3) == \
        jdelta_corpus.make_pairs(50, seed=3)
    for w in ("table", "desk", "chair", "unseen"):
        assert delta_corpus.oracle_synonym_ids(w) == \
            jdelta_corpus.oracle_synonym_ids(w)
    got = calibration.fit_meteor_shortfall(60, 1)
    want = jcalibration.fit_meteor_shortfall(60, 1)
    assert got == want
    assert calibration.calibrated_meteor_thresholds(n_pairs=60, seed=1) == \
        jcalibration.calibrated_meteor_thresholds(n_pairs=60, seed=1)


def _flat(d, prefix=""):
    if isinstance(d, dict):
        out = {}
        for k, v in d.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(d, (list, tuple)):
        out = {}
        for i, v in enumerate(d):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: d}


def _equal_results(got, want, tol=1e-9):
    g, w = _flat(got), _flat(want)
    assert set(g) == set(w)
    for k in w:
        if isinstance(w[k], str):
            assert g[k] == w[k], k
        else:
            assert abs(float(g[k]) - float(w[k])) <= tol, (k, g[k], w[k])


@pytest.fixture(scope="module")
def mini():
    with open(os.path.join(MINI, "pred.json")) as f:
        pred = json.load(f)
    with open(os.path.join(MINI, "gt_bbox.json")) as f:
        gt = json.load(f)
    return pred, gt


@pytest.mark.parametrize("rotated", [False, True])
def test_evaluate_matches_jax(mini, rotated):
    pred, gt = mini
    got = benchmark.evaluate(pred, gt, verbose=False, rotated_boxes=rotated,
                             device="cpu")
    want = jbenchmark.evaluate(pred, gt, verbose=False,
                               rotated_boxes=rotated)
    _equal_results(got, want)


def test_evaluate_pinned_values(mini):
    """tests/test_benchmark_fixture.py's pinned values."""
    pred, gt = mini
    r = benchmark.evaluate(pred, gt, verbose=False, device="cpu")
    det, cap, dc = r["detection"], r["captioning"], r["densecap"]
    assert det[0.25]["mAP"] == pytest.approx(5 / 9, abs=1e-6)
    assert det[0.5]["mAP"] == pytest.approx(4 / 9, abs=1e-6)
    assert det[0.25]["chair Average Precision"] == pytest.approx(1.0, abs=1e-6)
    assert det[0.5]["table Average Precision"] == 0.0
    assert det[0.25]["AR"] == pytest.approx(1.0, abs=1e-6)
    assert det[0.5]["AR"] == pytest.approx(2 / 3, abs=1e-6)
    assert cap[0]["f1-score"]["cider"] == pytest.approx(
        2.428363298459073, abs=1e-9)
    assert cap[0]["f1-score"]["bleu"][3] == pytest.approx(
        0.28573063340795246, abs=1e-9)
    assert cap[0]["f1-score"]["rouge"] == pytest.approx(
        0.6220915686765073, abs=1e-9)
    assert cap[0.5]["f1-score"]["cider"] == pytest.approx(
        2.4089519423061985, abs=1e-9)
    assert cap[0.5]["f1-score"]["rouge"] == pytest.approx(0.5, abs=1e-9)
    assert cap[0.5]["precision"]["bleu"][0] == pytest.approx(
        0.4374999998975696, abs=1e-9)
    assert cap[0.5]["recall"]["cider"] == pytest.approx(
        2.8104439326905646, abs=1e-9)
    assert dc["meteor_backend"] == benchmark.SENTENCE_METEOR_BACKEND
    if benchmark.SENTENCE_METEOR_BACKEND == "nltk-wordnet":
        pytest.skip("the METEOR pins hold for the built-in scorer")
    assert cap[0]["f1-score"]["meteor"] == pytest.approx(
        0.5714853036874351, abs=1e-9)
    assert cap[0.5]["f1-score"]["meteor"] == pytest.approx(
        0.4864111796982168, abs=1e-9)
    assert dc["mAP"] == pytest.approx(0.6, abs=1e-6)
    for iou in (0.1, 0.2, 0.3, 0.4, 0.5):
        assert dc["AP"][iou][0.15] == pytest.approx(2 / 3, abs=1e-6)
        assert dc["AP"][iou][0.75] == pytest.approx(1 / 3, abs=1e-6)
    assert "calibrated" in dc


@pytest.mark.parametrize("rotated", [False, True])
def test_assignment_matches_jax(mini, rotated):
    pred, gt = mini
    p = benchmark.organize_prediction(pred)
    g = benchmark.organize_gt(gt)
    got = benchmark.assign_pred_to_gt(p, g, rotated, device="cpu")
    want = jbenchmark.assign_pred_to_gt(jbenchmark.organize_prediction(pred),
                                        jbenchmark.organize_gt(gt), rotated)
    assert got[1:] == want[1:]
    assert got[0] == want[0]


def _script_build_gt():
    spec = importlib.util.spec_from_file_location(
        "jax_build_benchmark_gt",
        os.path.join(REPO, "scripts", "build_benchmark_gt.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.build_gt


def test_build_benchmark_gt_matches_the_script(tmp_path):
    data = write_cli_data(tmp_path, np.random.RandomState(0))
    path = build_benchmark_gt.main(["--split", "val", "--data", str(data)])
    with open(path) as f:
        got = json.load(f)
    with open(data / "ScanRefer_filtered_val.json") as f:
        entries = json.load(f)
    want = _script_build_gt()(entries, str(data / "scannet" / "scannet_data"))
    assert got == json.loads(json.dumps(want))
    assert len(got) == 2 and all(np.asarray(e["bbox"]).shape == (8, 3)
                                 for e in got)


def test_eval_cli_writes_its_results(mini, tmp_path):
    pred, gt = mini
    for name, content in (("pred.json", pred), ("gt.json", gt)):
        with open(tmp_path / name, "w") as f:
            json.dump(content, f)
    got = evalcli.main(["--path", str(tmp_path / "pred.json"), "--gt_path",
                        str(tmp_path / "gt.json"), "--no-verbose",
                        "--device", "cpu"])
    saved = json.loads((tmp_path / "eval_results.json").read_text())
    assert saved["detection"]["0.25"]["mAP"] == pytest.approx(5 / 9, abs=1e-6)
    assert got["detection"][0.25]["mAP"] == saved["detection"]["0.25"]["mAP"]
    assert evalcli.build_parser().parse_args(
        ["--path", "p", "--gt_path", "g"]).device == "cuda"


@pytest.mark.parametrize("empty", ["no_scenes", "no_boxes"])
def test_eval_cli_on_empty_predictions(mini, tmp_path, empty):
    """A run whose proposals all fall to NMS and objectness writes empty
    lists (or no scenes): the scorer reads zeros, as the JAX package's."""
    pred, gt = mini
    pred = {} if empty == "no_scenes" else {s: [] for s in pred}
    for name, content in (("pred.json", pred), ("gt.json", gt)):
        with open(tmp_path / name, "w") as f:
            json.dump(content, f)
    got = evalcli.main(["--path", str(tmp_path / "pred.json"), "--gt_path",
                        str(tmp_path / "gt.json"), "--no-verbose",
                        "--device", "cpu"])
    assert (tmp_path / "eval_results.json").exists()
    want = jbenchmark.evaluate(pred, gt, verbose=False)
    _equal_results(got, want)
    assert got["detection"][0.5]["mAP"] == 0.0
    assert got["densecap"]["mAP"] == 0.0
    assert got["captioning"][0.5]["f1-score"]["cider"] == 0.0
