"""``scan2cap_torch.scripts.dryrun_multicard`` on the CPU, held against the
JAX package (the counterpart of ``__graft_entry__.dryrun_multichip``).

Its three stages run over four gloo ranks at the JAX dryrun's tiny
configuration (``__graft_entry__._flagship_cfg(tiny=True)``, B=8, 64
words, one torch thread a rank) on JAX's own initial weights
(``convert.state_dict_from_flax``):

* flagship, at (2, 2) and (4, 1): the eval tokens gathered over the ranks
  equal jitted one-device JAX's exactly, the train step's loss is within
  2e-3 relative of JAX's one-device step (``__graft_entry__``'s bound),
  and the script's own gates against the port's one process hold with
  every token equal; a (4, 1) step issues no model-axis collective;
* spatial, (1, 4) over 1,024 points: sa1, sa2 and fp2 indices exactly
  JAX's unsharded backbone's, fp2 features within 2e-5 of their scale,
  no collective from FPS;
* dp_spatial, (2, 2): no data-axis collective, each rank's scene's
  indices JAX's.

Beside them: the size-one elision (a (4, 1) step's loss and gradients
bitwise those of the same step with the elision patched off, which then
issues model-axis calls), the byte counts against the tensors' sizes, the
mesh shapes and batch sizes against the JAX dryrun's rule, and the entry
point on two gloo ranks.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from __graft_entry__ import _flagship_cfg
from scan2cap_tpu.config import Config
from scan2cap_tpu.data.synthetic import make_scene_batch as jmake_scene_batch
from scan2cap_tpu.data.synthetic import make_vocab as jmake_vocab
from scan2cap_tpu.models import CapNet as JCapNet
from scan2cap_tpu.models.backbone import Pointnet2Backbone as JBackbone
from scan2cap_tpu.train import create_train_state, make_eval_step
from scan2cap_tpu.train import make_train_step

import torch_mesh_ranks as ranks
from scan2cap_torch.convert import state_dict_from_flax
from scan2cap_torch.parallel import mesh as pmesh
from scan2cap_torch.scripts import dryrun_multicard as dryrun

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4
SHAPES = [(2, 2), (4, 1)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jref():
    """JAX's tiny dryrun on one device: eval tokens and one train step's
    loss; its unsharded backbone on the spatial stage's cloud; both sets of
    weights converted for the port."""
    jcfg = _flagship_cfg(tiny=True)
    config = Config(model=jcfg)
    vocab = jmake_vocab(num_vocabs=dryrun.TINY_VOCABS, emb_size=jcfg.emb_size)
    batch = jmake_scene_batch(jcfg, batch_size=dryrun.batch_size(N, True),
                              num_objects=3, vocab=vocab)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    model = JCapNet(jcfg, num_vocabs=dryrun.TINY_VOCABS)
    state = create_train_state(config, model, jbatch, jax.random.PRNGKey(0))
    tokens = np.asarray(make_eval_step(config, model)(state, jbatch)[
        "lang_cap"])
    step = make_train_step(config, model, donate=False, **dryrun.LOSSES)
    _, metrics = step(state, jbatch, jnp.asarray(dryrun.LR),
                      jnp.asarray(dryrun.BN_MOMENTUM))

    pc = dryrun.spatial_inputs(dryrun.flagship_cfg(True), True)
    net = JBackbone(jcfg.input_feature_dim, jcfg.sa_npoints)
    cloud = {"point_clouds": jnp.asarray(pc)}
    variables = jax.jit(net.init, static_argnums=(2,))(
        jax.random.PRNGKey(0), cloud, False)
    out = jax.jit(lambda v, b: net.apply(v, b, False))(variables, cloud)
    return dict(
        batch=batch, tokens=tokens, loss=float(metrics["loss"]),
        capnet=state_dict_from_flax(state.params, state.batch_stats),
        backbone=state_dict_from_flax(variables["params"],
                                      variables["batch_stats"]),
        spatial={k: np.asarray(out[k])
                 for k in dryrun.SPATIAL_KEYS + ("fp2_features",)})


@pytest.fixture(scope="module")
def report(jref):
    return dryrun.run(N, "cpu", weights=dict(capnet=jref["capnet"],
                                             backbone=jref["backbone"]),
                      timing=False)


@pytest.fixture(scope="module")
def elision(jref):
    cfg_kw = dataclasses.asdict(dryrun.flagship_cfg(True))
    return pmesh.launch(pmesh.MeshSpec(4, 1), "cpu", ranks.elision_and_bytes,
                        cfg_kw, dryrun.TINY_VOCABS, jref["capnet"],
                        jref["batch"])


def test_flagship_config_and_shapes_follow_the_jax_dryrun():
    want = dataclasses.asdict(_flagship_cfg(tiny=False))
    for tiny in (False, True):
        got = dataclasses.asdict(dryrun.flagship_cfg(tiny))
        want = dataclasses.asdict(_flagship_cfg(tiny=tiny))
        common = set(got) & set(want)
        assert {"num_points", "num_locals", "use_multiview",
                "sa_npoints"} <= common
        assert {k: got[k] for k in common} == {k: want[k] for k in common}
    assert dryrun.mesh_shapes(1) == [(1, 1)]
    assert dryrun.mesh_shapes(2) == [(1, 2), (2, 1)]
    assert dryrun.mesh_shapes(4) == [(2, 2), (4, 1)]
    assert dryrun.mesh_shapes(3) == [(3, 1)]
    # 8 rounded up to every data axis, as device_put needs even shards
    assert [dryrun.batch_size(n, False) for n in (1, 2, 3, 4, 6, 8)] == \
        [8, 8, 9, 8, 12, 8]
    assert dryrun.batch_size(4, True) == 8


@pytest.mark.parametrize("i", range(len(SHAPES)))
def test_flagship_eval_tokens_equal_jax(report, jref, i):
    ref = report["outputs"]["reference"]
    np.testing.assert_array_equal(ref["lang_cap"].numpy(), jref["tokens"])
    got = report["outputs"]["ranks"][0]["flagship"][i]
    assert got["shape"] == list(SHAPES[i])
    np.testing.assert_array_equal(got["lang_cap"].numpy(), jref["tokens"])


@pytest.mark.parametrize("i", range(len(SHAPES)))
def test_flagship_loss_within_2e3_of_jax(report, jref, i):
    got = report["outputs"]["ranks"][0]["flagship"][i]["loss"]
    want = jref["loss"]
    assert abs(got - want) <= 2e-3 * abs(want), (got, want)


@pytest.mark.parametrize("i", range(len(SHAPES)))
def test_flagship_gates_hold_against_one_process(report, i):
    row = report["flagship"][i]
    assert row["failed"] == [] and report["failed"] == []
    assert row["tokens_differing"] == 0 and row["tokens_equal"] == 1.0
    assert row["differing_picks"]["sa1_inds"] == 0
    assert row["loss_rel_diff"] <= dryrun.LOSS_REL
    step = row["step_collectives"]
    for counts in step:
        assert counts["data"]["calls"] > 0 and counts["data"]["bytes"] > 0
        # the model axis of (4, 1) holds one rank: nothing is issued on it
        assert (counts["model"]["calls"] > 0) == (SHAPES[i][1] > 1)


def test_spatial_stage_exact_against_jax_backbone(report, jref):
    want = jref["spatial"]
    rank0 = report["outputs"]["ranks"][0]["spatial"]
    assert rank0["shape"] == [1, N]
    for k in dryrun.SPATIAL_KEYS:
        np.testing.assert_array_equal(rank0[k].numpy(), want[k], err_msg=k)
    scale = float(np.abs(want["fp2_features"]).max())
    diff = float(np.abs(rank0["fp2_features"].numpy()
                        - want["fp2_features"]).max())
    assert diff <= dryrun.FEATURE_REL * max(scale, 1.0), (diff, scale)


def test_spatial_stage_fps_needs_no_collective(report):
    s = report["spatial"]
    assert s["failed"] == [] and s["fps_collectives"] == [0] * N
    for counts in s["collectives"]:
        assert counts["data"]["calls"] == 0 and counts["model"]["calls"] > 0


def test_dp_spatial_stage_has_no_data_axis_collective(report, jref):
    d = report["dp_spatial"]
    assert d["shape"] == [2, N // 2] and d["failed"] == []
    for counts in d["collectives"]:
        assert counts["data"]["calls"] == 0 and counts["model"]["calls"] > 0
    want = jref["spatial"]
    for r in report["outputs"]["ranks"]:
        got = r["dp_spatial"]
        if "sa1_inds" in got:
            for k in dryrun.SPATIAL_KEYS:
                np.testing.assert_array_equal(
                    got[k].numpy(), want[k][got["d"]:got["d"] + 1], err_msg=k)


def test_size_one_elision_is_bitwise(elision):
    on, off = elision[True], elision[False]
    assert on["calls"].get("model", 0) == 0 and on["calls"]["data"] > 0
    assert off["calls"]["model"] > 0
    assert on["calls"]["data"] == off["calls"]["data"]
    assert on["loss"] == off["loss"]
    assert set(on["grads"]) == set(off["grads"])
    for name, g in on["grads"].items():
        assert torch.equal(g, off["grads"][name]), name


def test_collective_bytes_are_the_tensors_sizes(elision):
    calls, nbytes = elision["bytes"]
    f32 = 3 * 5 * 4
    # data: an all-reduce of (3, 5) float32 and two ranks' 4 bools (as
    # uint8); model: an all-reduce, two ranks' (2, 3) int32, two ranks'
    # (2, 7) float64
    assert calls == {"data": 2, "model": 3}
    assert nbytes == {"data": f32 + 2 * 4, "model": f32 + 2 * 2 * 3 * 4
                      + 2 * 2 * 7 * 8}
    calls, nbytes, y = elision["size_one"]
    assert calls == {} and nbytes == {}
    assert torch.equal(y, torch.arange(15, dtype=torch.float32).reshape(3, 5))


def test_entry_point_on_two_gloo_ranks(tmp_path):
    out = tmp_path / "dryrun.json"
    run = subprocess.run(
        [sys.executable, "-m", "scan2cap_torch.scripts.dryrun_multicard",
         "--cards", "2", "--device", "cpu", "--json", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert run.returncode == 0, (run.stdout[-2000:], run.stderr[-3000:])
    report = json.loads(run.stdout.strip().splitlines()[-1])
    assert report == json.loads(out.read_text())
    assert report["failed"] == [] and report["cards"] == 2
    assert [f["shape"] for f in report["flagship"]] == [[1, 2], [2, 1]]
    assert report["dp_spatial"]["shape"] == [2, 1]
    cells = {(tuple(t["shape"]), t["global_batch"], t["rank"])
             for t in report["timing"]}
    assert cells == {((1, 1), 8, 0), ((2, 1), 8, 0), ((2, 1), 8, 1),
                     ((2, 1), 16, 0), ((2, 1), 16, 1)}
    assert "flagship [1, 2]" in run.stdout
    # more ranks than the CPU mesh allows stops with a message
    bad = subprocess.run(
        [sys.executable, "-m", "scan2cap_torch.scripts.dryrun_multicard",
         "--cards", str(pmesh.CPU_DEVICES + 1), "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert bad.returncode != 0 and "--cards 9" in bad.stderr
