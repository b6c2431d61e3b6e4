"""The port's serving slice against the JAX package, end to end on the CPU.

The flagship flags (2 graph steps, 10 locals, top-down decoder, relation
and orientation heads, normal + multiview + height input) at a small size:
2048 points, SA counts (256, 128, 64, 32), 32 proposals, hidden 64,
embedding 32, a vocabulary of 40.  The JAX CapNet is initialised once per
module, its weights are carried into the port with
``convert.state_dict_from_flax`` + ``load_state_dict(strict=True)``, and both
eval steps answer the same synthetic batch.  Indices and tokens must be
equal; floats within 1e-4 (absolute or relative).

Also the package rules: the port imports nothing of JAX, Flax or
``scan2cap_tpu``, and its entry points need CUDA unless given
``device="cpu"``.
"""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from scan2cap_tpu.config import Config
from scan2cap_tpu.config import ModelConfig as JModelConfig
from scan2cap_tpu.data import synthetic as jsynthetic
from scan2cap_tpu.models import CapNet as JCapNet
from scan2cap_tpu.train import step as jstep

from scan2cap_torch.config import ModelConfig
from scan2cap_torch.convert import state_dict_from_flax
from scan2cap_torch.data import synthetic
from scan2cap_torch.models import CapNet
from scan2cap_torch.probes import gather as gather_probe
from scan2cap_torch.probes import pack as pack_probe
from scan2cap_torch.probes import shift as shift_probe
from scan2cap_torch.train.step import (TrainState, create_train_state,
                                       make_eval_step, make_optimizer,
                                       make_train_step)

V = 40
CFG = dict(num_points=2048, sa_npoints=(256, 128, 64, 32), num_proposals=32,
           hidden_size=64, emb_size=32, num_graph_steps=2, num_locals=10,
           use_topdown=True, use_relation=True, use_orientation=True,
           use_normal=True, use_multiview=True)
INDEX_KEYS = ("sa1_inds", "sa2_inds", "fp2_inds", "aggregated_vote_inds",
              "edge_nbr_idx", "bbox_mask", "lang_cap", "topdown_attn_slots")
FLOAT_KEYS = ("bbox_corner", "objectness_scores", "sem_cls_scores",
              "bbox_feature", "topdown_attn", "center", "size_residuals",
              "valid_masks")


def _batch(cfg, vocab):
    b = synthetic.make_scene_batch(cfg, batch_size=2, num_objects=4,
                                   vocab=vocab, seed=0)
    # seeded normals and multiview features in place of the zeros
    rs = np.random.RandomState(1)
    b["point_clouds"][..., 3:3 + 131] = (
        rs.randn(2, cfg.num_points, 131).astype(np.float32) * 0.1)
    return b


@pytest.fixture(scope="module")
def runs():
    jcfg, cfg = JModelConfig(**CFG), ModelConfig(**CFG)
    vocab = synthetic.make_vocab(num_vocabs=V, emb_size=cfg.emb_size)
    batch = _batch(cfg, vocab)
    # the JAX init traces the teacher-forced path, which reads the labels
    # of the full JAX batch; the eval forward reads only the port's keys
    jbatch = jsynthetic.make_scene_batch(jcfg, batch_size=2, num_objects=4,
                                         vocab=vocab, seed=0)
    jbatch.update(batch)
    jbatch = {k: jnp.asarray(v) for k, v in jbatch.items()}

    jmodel = JCapNet(jcfg, num_vocabs=V)
    state = jstep.create_train_state(Config(model=jcfg), jmodel, jbatch,
                                     jax.random.PRNGKey(0))
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    jfull = jax.jit(lambda v, d: jmodel.apply(
        v, d, use_tf=False, is_eval=True, train=False))(variables, jbatch)
    jeval = jstep.make_eval_step(Config(model=jcfg), jmodel,
                                 detection_loss=False, keep_attn=True)(
        state, jbatch)

    model = CapNet(cfg, num_vocabs=V, device="cpu")
    load = model.load_state_dict(
        state_dict_from_flax(state.params, state.batch_stats), strict=True)
    tbatch = synthetic.to_device(batch, "cpu")
    with torch.inference_mode():
        tfull = model(tbatch)
    teval = make_eval_step(cfg, model, detection_loss=False,
                           keep_attn=True)(tbatch)
    as_np = lambda d: {k: np.asarray(v) for k, v in d.items()}
    return dict(load=load, batch=batch, vocab=vocab, jcfg=jcfg, jbatch=jbatch,
                params=state.params, batch_stats=state.batch_stats,
                jfull=as_np(jfull), jeval=as_np(jeval),
                tfull={k: v.numpy() for k, v in tfull.items()
                       if isinstance(v, torch.Tensor)},
                teval={k: v.numpy() for k, v in teval.items()})


def test_weights_carry_strict(runs):
    assert not runs["load"].missing_keys
    assert not runs["load"].unexpected_keys


def test_synthetic_batch_matches_jax(runs):
    jc = runs["jcfg"]
    jvocab = jsynthetic.make_vocab(num_vocabs=V, emb_size=jc.emb_size)
    np.testing.assert_array_equal(runs["vocab"]["emb_table"],
                                  jvocab["emb_table"])
    assert runs["vocab"]["word2idx"] == jvocab["word2idx"]
    jb = jsynthetic.make_scene_batch(jc, batch_size=2, num_objects=4,
                                     vocab=jvocab, seed=0)
    b = synthetic.make_scene_batch(ModelConfig(**CFG), batch_size=2,
                                   num_objects=4, vocab=runs["vocab"], seed=0)
    for k, v in b.items():
        np.testing.assert_array_equal(v, jb[k], err_msg=k)


@pytest.mark.parametrize("key", INDEX_KEYS)
def test_forward_indices_exact(runs, key):
    got, want = runs["tfull"][key], runs["jfull"][key]
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_forward_is_not_degenerate(runs):
    # both proposal classes occur, so the graph and the caption gates see
    # valid and invalid boxes; the decoder writes more than one token
    mask = runs["tfull"]["bbox_mask"]
    assert 0 < mask.sum() < mask.size
    assert len(np.unique(runs["tfull"]["lang_cap"])) > 1


@pytest.mark.parametrize("key", FLOAT_KEYS)
def test_forward_floats_close(runs, key):
    np.testing.assert_allclose(runs["tfull"][key], runs["jfull"][key],
                               rtol=1e-4, atol=1e-4)


def test_eval_step_matches_jax(runs):
    got, want = runs["teval"], runs["jeval"]
    assert set(got) == set(want)
    for k in got:
        if np.issubdtype(want[k].dtype, np.floating):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_padded_vocab_classifier_matches_jax(runs):
    # a classifier widened past the vocabulary (a checkpoint of a
    # vocab-padded JAX CapNet); the pad columns carry a large bias, so
    # argmax would pick them at every step unless they are masked to -1e30
    VP = V + 8
    cls = runs["params"]["caption"]["classifier"]
    rs = np.random.RandomState(2)
    kernel = np.concatenate([np.asarray(cls["kernel"]), rs.randn(
        CFG["hidden_size"], VP - V).astype(np.float32)], axis=1)
    bias = np.concatenate([np.asarray(cls["bias"]),
                           np.full(VP - V, 100.0, np.float32)])
    params = dict(runs["params"])
    params["caption"] = {**params["caption"],
                         "classifier": {"kernel": kernel, "bias": bias}}
    jmodel = JCapNet(runs["jcfg"], num_vocabs=V, num_vocabs_padded=VP)
    jout = jax.jit(lambda v, d: jmodel.apply(
        v, d, use_tf=False, is_eval=True, train=False))(
        {"params": params, "batch_stats": runs["batch_stats"]},
        runs["jbatch"])
    model = CapNet(ModelConfig(**CFG), num_vocabs=V, num_vocabs_padded=VP,
                   device="cpu")
    model.load_state_dict(state_dict_from_flax(params, runs["batch_stats"]),
                          strict=True)
    assert model.caption.classifier.out_features == VP
    with torch.inference_mode():
        tout = model(synthetic.to_device(runs["batch"], "cpu"))
    want = np.asarray(jout["lang_cap"])
    np.testing.assert_array_equal(want, runs["jfull"]["lang_cap"])
    np.testing.assert_array_equal(tout["lang_cap"].numpy(), want)
    assert tout["lang_cap"].max() < V


def test_package_imports_nothing_of_jax():
    code = (
        "import sys\n"
        "import scan2cap_torch, scan2cap_torch.config, scan2cap_torch.convert\n"
        "import scan2cap_torch.ops, scan2cap_torch.kernels\n"
        "import scan2cap_torch.ops.nn_distance\n"
        "import scan2cap_torch.kernels.gather, scan2cap_torch.kernels.pack_probe\n"
        "import scan2cap_torch.models, scan2cap_torch.train.step\n"
        "import scan2cap_torch.train.schedules, scan2cap_torch.losses\n"
        "import scan2cap_torch.losses.detection, scan2cap_torch.losses.caption\n"
        "import scan2cap_torch.losses.total, scan2cap_torch.probes\n"
        "import scan2cap_torch.probes.pack, scan2cap_torch.probes.shift\n"
        "import scan2cap_torch.probes.gather\n"
        "import scan2cap_torch.data.synthetic\n"
        "import scan2cap_torch.models.enet, scan2cap_torch.data.projection\n"
        "import scan2cap_torch.data.frames, scan2cap_torch.utils.colors\n"
        "import scan2cap_torch.utils.ply\n"
        "import scan2cap_torch.scripts.quality_trajectory\n"
        "import scan2cap_torch.scripts.demo_synthetic_train\n"
        "import scan2cap_torch.scripts.compute_multiview_features\n"
        "import scan2cap_torch.scripts.project_multiview_features\n"
        "import scan2cap_torch.scripts.project_multiview_labels\n"
        "import pkgutil\n"
        "for m in pkgutil.walk_packages(scan2cap_torch.__path__,\n"
        "                               'scan2cap_torch.'):\n"
        "    __import__(m.name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax',\n"
        "                                    'scan2cap_tpu'))\n"
        "assert not bad, bad\n"
        "# Pillow and h5py only at the call that needs them\n"
        "assert 'PIL' not in sys.modules and 'h5py' not in sys.modules\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=root)


def test_entry_points_need_cuda_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    cfg = ModelConfig(**CFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CapNet(cfg, num_vocabs=V)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        synthetic.to_device({"x": np.zeros(3, np.float32)})
    # a model that was built for the card but does not lie on it
    model = CapNet(cfg, num_vocabs=V, device="cpu")
    model.device = torch.device("cuda")
    for entry in (lambda: create_train_state(cfg, model),
                  lambda: make_eval_step(cfg, model),
                  lambda: make_train_step(
                      cfg, TrainState(model, make_optimizer(model.parameters())))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry()
    # the probes' entry points default to the card too
    for run in (pack_probe.run, shift_probe.run, gather_probe.run):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run()


def test_chip_smoke_fails_without_cuda_and_imports_nothing_of_jax():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the smoke run would start")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import runpy, sys\n"
        "sys.argv = ['chip_smoke.py']\n"
        "try:\n"
        "    runpy.run_path('chip_smoke.py', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    rc = e.code\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'optax', 'scan2cap_tpu'))\n"
        "assert not bad, bad\n"
        "sys.exit(rc)\n")
    run = subprocess.run([sys.executable, "-c", code], cwd=root, timeout=120,
                         capture_output=True, text=True)
    assert run.returncode not in (0, None)
    assert '"ok"' not in run.stdout
