"""The port's last small modules against the JAX package's, on the CPU.

* ``losses/ranking.softmax_ranking_loss``: the golden of
  ``tests/test_losses.py:158-175`` and JAX's value and gradient (1e-6).
* ``utils/metric_util``: the goldens of ``tests/test_nms_ap.py:150`` and
  JAX's counts on random scenes, exactly.
* ``utils/profiling``: ``trace`` writes a Chrome trace with the
  ``annotate`` spans, ``StepTimer`` means, ``check_finite`` over dicts and
  lists.
* ``scripts/profile_report``: the top operations of a trace by summed time
  (a hand-made trace with kernels, and a real CPU trace).
* ``scripts/profile_host_pipeline`` at 2 scenes: the same files as the JAX
  script (its HDF5 converted to the store bitwise), the port's dataset and
  Loader with the native plane, its JSON line.
"""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from scan2cap_torch.losses.ranking import softmax_ranking_loss
from scan2cap_torch.utils import metric_util, profiling


def test_softmax_ranking_loss_golden_and_jax(rng):
    from scan2cap_tpu.losses.ranking import softmax_ranking_loss as jloss

    x = rng.randn(4, 6).astype(np.float32)
    y = np.zeros((4, 6), np.float32)
    y[np.arange(4), rng.randint(0, 6, 4)] = 1.0
    y[0, 3] = 1.0                                 # multi-hot row
    ex = np.exp(x + 1e-8 - (x + 1e-8).max(1, keepdims=True))
    probs = ex / ex.sum(1, keepdims=True)
    golden = float(np.mean(-np.sum(np.log(probs + 1e-8) * y, axis=1)))
    tx = torch.tensor(x, requires_grad=True)
    loss = softmax_ranking_loss(tx, torch.from_numpy(y))
    np.testing.assert_allclose(float(loss.detach()), golden, rtol=1e-5)
    want = float(jax.jit(jloss)(jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_allclose(float(loss.detach()), want, rtol=1e-6)
    loss.backward()
    g = jax.jit(jax.grad(lambda a: jloss(a, jnp.asarray(y))))(jnp.asarray(x))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(g), atol=1e-6)
    # the gradient pushes the target logit up
    assert float(tx.grad[1, np.argmax(y[1])]) < 0
    with pytest.raises(AssertionError):
        softmax_ranking_loss(tx, torch.zeros(4, 5))


def test_metric_util_goldens():
    assert metric_util.calc_iou(np.array([0, 0, 0, 1, 1, 1.0]),
                                np.array([0, 0, 0, 2, 2, 2.0])) == 1.0 / 8
    assert metric_util.calc_iou(np.array([0, 0, 0, 1, 1, 1.0]),
                                np.array([10, 10, 10, 2, 2, 2.0])) == 0.0
    gt = np.array([[0, 0, 0, 1, 1, 1], [5, 5, 5, 1, 1, 1.0]])
    pred = np.array([
        [0, 0, 0, 1, 1, 1, 0.9],      # TP (IoU 1 with gt 0)
        [0.1, 0, 0, 1, 1, 1, 0.8],    # TP (also matches gt 0)
        [9, 9, 9, 1, 1, 1, 0.9],      # FP
        [5, 5, 5, 1, 1, 1, 0.01],     # below conf -> ignored
    ])
    assert metric_util.single_scene_precision_recall(
        gt, pred, 0.5, 0.1) == (2, 1, 1)
    TP, FP, FN, (prec, rec) = metric_util.multi_scene_precision_recall(
        gt[None], pred[None], 0.5, 0.1,
        label_mask=np.ones((1, 2)), pred_mask=np.ones((1, 4)))
    assert (TP, FP, FN) == (2, 1, 1)
    assert abs(prec - 2 / 3) < 1e-9 and abs(rec - 2 / 3) < 1e-9


def test_metric_util_matches_jax(rng):
    from scan2cap_tpu.utils import metric_util as jmetric

    B, N, M = 3, 6, 12
    labels = np.concatenate([rng.uniform(-2, 2, (B, N, 3)),
                             rng.uniform(0.3, 1.5, (B, N, 3))], -1)
    pred = np.concatenate([labels[:, rng.randint(0, N, M), :3]
                           + rng.randn(B, M, 3) * 0.2,
                           rng.uniform(0.3, 1.5, (B, M, 3)),
                           rng.rand(B, M, 1)], -1)
    label_mask = (rng.rand(B, N) > 0.2).astype(np.float64)
    pred_mask = (rng.rand(B, M) > 0.2).astype(np.float64)
    for iou, conf in ((0.25, 0.05), (0.5, 0.3)):
        got = metric_util.multi_scene_precision_recall(
            labels, pred, iou, conf, label_mask, pred_mask)
        want = jmetric.multi_scene_precision_recall(
            labels, pred, iou, conf, label_mask, pred_mask)
        assert got == want
    a, b = labels[0, 0], pred[0, 0, :6]
    assert metric_util.calc_iou(a, b) == jmetric.calc_iou(a, b)
    assert metric_util.precision_recall(0, 0, 3) == (0.0, 0.0)


def test_profiling_trace_timer_and_finite_check(tmp_path):
    with profiling.trace(str(tmp_path / "prof")):
        with profiling.annotate("my_span"):
            torch.randn(64, 64) @ torch.randn(64, 64)
    with open(tmp_path / "prof" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "my_span" in names and "aten::mm" in names

    timer = profiling.StepTimer()
    for _ in range(3):
        with timer.phase("fetch"):
            pass
    with timer.phase("step"):
        pass
    assert set(timer.report()) == {"fetch", "step"}
    assert len(timer.times["fetch"]) == 3
    assert timer.mean("fetch") >= 0.0 and timer.mean("none") == 0.0
    assert timer.mean("fetch", last=1) == timer.times["fetch"][-1]

    ok = {"a": torch.ones(3), "b": [torch.zeros(2), torch.arange(3)],
          "c": np.ones(2)}
    profiling.check_finite(ok)
    for bad, where in (({"a": torch.tensor([1.0, float("nan")])}, "['a']"),
                       ([torch.ones(1), {"x": torch.tensor([float("inf")])}],
                        "[1]['x']"),
                       ({"n": np.array([np.nan])}, "['n']")):
        with pytest.raises(FloatingPointError) as err:
            profiling.check_finite(bad, "loss")
        assert str(err.value) == f"non-finite values in loss: [{where!r}]"


def test_profile_report(tmp_path, capsys):
    from scan2cap_torch.scripts import profile_report

    trace = {"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "fps_kernel", "dur": 1500.0},
        {"ph": "X", "cat": "kernel", "name": "bq_kernel", "dur": 100.0},
        {"ph": "X", "cat": "kernel", "name": "fps_kernel", "dur": 500.0},
        {"ph": "X", "cat": "kernel", "name": "gather_kernel", "dur": 400.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "dur": 9000.0},
        {"ph": "i", "cat": "kernel", "name": "marker"},
    ]}
    run = tmp_path / "run" / "profile"
    run.mkdir(parents=True)
    with open(run / "trace.json", "w") as f:
        json.dump(trace, f)
    rows = profile_report.main(["--trace", str(run), "--top", "2"])
    assert [r[:3] for r in rows] == [("fps_kernel", 2.0, 2),
                                     ("gather_kernel", 0.4, 1)]
    assert abs(rows[0][3] - 0.8) < 1e-12
    assert "sum of event time 2.500 ms over 4 events" in \
        capsys.readouterr().out
    # a trace of the CPU alone ranks the host's operations
    with profiling.trace(str(tmp_path / "cpu")):
        torch.randn(32, 32) @ torch.randn(32, 32)
    rows = profile_report.summarize(str(tmp_path / "cpu" / "trace.json"))
    assert "aten::mm" in {r[0] for r in rows}
    with pytest.raises(SystemExit):
        profile_report.main(["--trace", str(tmp_path / "nothing")])


def test_profile_host_pipeline_two_scenes(tmp_path):
    import argparse
    import importlib.util
    import h5py

    from scan2cap_torch.data.feature_store import open_feature_store
    from scan2cap_torch.scripts import profile_host_pipeline as php

    argv = ["--num_scenes", "2", "--anns_per_scene", "4",
            "--scene_points", "6000", "--num_points", "2048",
            "--batch_size", "2", "--workers", "2", "--measure_batches", "2",
            "--warmup_batches", "1"]
    out = php.main(["--root", str(tmp_path / "port")] + argv)
    assert out["metric"] == "host_pipeline_samples_per_sec"
    assert out["value"] > 0 and out["num_scenes"] == 2
    assert out["native_plane"] is True
    # the JAX script's synthesis, from the same seed: the same files, its
    # multiview HDF5 the port's store key for key
    spec = importlib.util.spec_from_file_location(
        "jax_php", os.path.join(os.path.dirname(__file__), os.pardir,
                                "scripts", "profile_host_pipeline.py"))
    jphp = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jphp)
    jphp.synthesize(argparse.Namespace(
        root=str(tmp_path / "jax"), num_scenes=2, anns_per_scene=4,
        scene_points=6000))
    for name in sorted(os.listdir(tmp_path / "jax" / "scannet")):
        a = np.load(tmp_path / "jax" / "scannet" / name)
        b = np.load(tmp_path / "port" / "scannet" / name)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    for name in ("ScanRefer_filtered_train.json",):
        with open(tmp_path / "jax" / name) as f, \
                open(tmp_path / "port" / name) as g:
            assert json.load(f) == json.load(g)
    with h5py.File(tmp_path / "jax" / "enet_feats_maxpool.hdf5", "r") as h, \
            open_feature_store(str(tmp_path / "port" /
                                   "enet_feats_maxpool.npz")) as s:
        assert sorted(s.keys()) == sorted(h.keys())
        for k in h.keys():
            assert s[k].tobytes() == np.asarray(h[k]).tobytes()
    # a second run reuses the data on disk, with a simulated consumer
    out = php.main(["--root", str(tmp_path / "port"), "--step_ms", "1"]
                   + argv)
    assert out["step_ms_simulated"] == 1.0
    assert 0.0 <= out["fetch_occupancy_pct"] <= 100.0
