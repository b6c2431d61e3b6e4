"""The port's MaskVoteNet track against the JAX package's, on the CPU.

The launch script's configuration (``launch/train_maskvotenet.sh``:
multiview + normal + height, and the mask channel) at a small size: 1,024
points, SA counts (64, 32, 16, 8), one proposal, B=4.  The same seeded
numpy batch (``data.synthetic.make_mask_votenet_batch``) and the JAX
model's initial weights (carried with ``convert.state_dict_from_flax``) go
through jitted JAX and the port.

Tolerances:
* the eval forward: indices exact, floats within 1e-4 of the tensor's
  largest magnitude;
* each loss function, and its gradient with respect to every prediction it
  reads: 1e-5 (as ``tests/test_torch_losses.py``);
* one whole train step: the loss within 2.5e-5 relative, every other
  reported metric within 1e-4 relative (1e-5 absolute below 0.1), as
  ``tests/test_torch_train.py`` holds the CapNet step.  Measured: the loss
  differs from jitted JAX's by 1.26e-5 relative (98.97655 against
  98.97780); the box terms by 2e-5 to 5.4e-5.  That is float32's noise on
  this loss, not 1e-5 reachable: jitted and op-by-op JAX differ by 1.07e-5
  on the same step, and each package's float32 loss lies 2.6e-5 (the port)
  and 3.9e-5 (jitted JAX) from the port's float64 evaluation.  The train
  forward normalises with batch statistics over 20 layers, and the two
  packages' float32 sums of a layer's products differ in order (the train
  forward's aggregated features differ by 7.5e-5 of their largest
  value); gradients within 1e-2 * max|g| + 1e-6 per tensor with a
  median of at most 1e-3 over the tensors.  At B=2 the proposal head's
  batch norm normalises two samples, whose gradient cancels to rounding
  residue in both packages: B=4 keeps it a real gradient.
* dataset items and Loader batches, and the ``.pth`` layout: exact.
"""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests.test_dataset import make_fixture_glove, make_fixture_scene
from tests.test_torch_cli import write_cli_data

from scan2cap_tpu import convert as jconvert
from scan2cap_tpu.config import ModelConfig as JModelConfig
from scan2cap_tpu.data import dataset as jdataset
from scan2cap_tpu.data import dataset_maskvotenet as jmask_dataset
from scan2cap_tpu.losses import mask_votenet as jmask_losses
from scan2cap_tpu.models.mask_votenet import MaskVoteNet as JMaskVoteNet

from scan2cap_torch import convert
from scan2cap_torch.config import SCANNET_MEAN_SIZE_ARR, ModelConfig
from scan2cap_torch.convert import named_from_flax, state_dict_from_flax
from scan2cap_torch.data import dataset, synthetic
from scan2cap_torch.data import dataset_maskvotenet as mask_dataset
from scan2cap_torch.losses import mask_votenet as mask_losses
from scan2cap_torch.models.mask_votenet import MaskVoteNet
from scan2cap_torch.scripts import train_maskvotenet as mvncli
from scan2cap_torch.train.checkpoints import CheckpointIO
from scan2cap_torch.train.step import (MVN_REPORT_KEYS, create_train_state,
                                       make_mask_votenet_step)

B = 4
CFG = dict(num_points=1024, sa_npoints=(64, 32, 16, 8), num_proposals=1,
           max_num_obj=1, use_normal=True, use_multiview=True,
           no_caption=True)
LR, BN_MOMENTUM = 1e-3, 0.1
INDEX_KEYS = ("sa1_inds", "sa2_inds", "fp2_inds", "aggregated_vote_inds")
FLOAT_KEYS = ("sa1_features", "fp2_features", "vote_xyz", "vote_features",
              "aggregated_vote_xyz", "aggregated_vote_features", "center",
              "size_scores", "size_residuals_normalized", "size_residuals",
              "sem_cls_scores")


def _batch(cfg, seed=3):
    b = synthetic.make_mask_votenet_batch(cfg, B, num_objects=4, seed=seed)
    rs = np.random.RandomState(1)
    # seeded normals and multiview features in place of the zeros
    width = 3 * cfg.use_normal + 128 * cfg.use_multiview
    b["point_clouds"][..., 3:3 + width] = (
        rs.randn(B, cfg.num_points, width).astype(np.float32) * 0.1)
    return b


def _jax_model(cfg_kw, batch):
    jmodel = JMaskVoteNet(JModelConfig(**cfg_kw))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jax.jit(jmodel.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), jbatch, train=False)
    return jmodel, jbatch, variables


def _port(cfg, variables):
    model = MaskVoteNet(cfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(
        variables["params"], variables["batch_stats"]), strict=True)
    return model


@pytest.fixture(scope="module")
def runs():
    cfg = ModelConfig(**CFG)
    batch = _batch(cfg)
    jmodel, jbatch, variables = _jax_model(CFG, batch)

    jeval = jax.jit(jmodel.apply, static_argnames=("train",))(
        variables, jbatch, train=False)

    def loss_fn(params, batch_stats, data):
        out, mutated = jmodel.apply(
            {"params": params, "batch_stats": batch_stats}, data,
            train=True, bn_momentum=BN_MOMENTUM, mutable=["batch_stats"])
        out = jmask_losses.get_mask_votenet_loss(out)
        return out["loss"], (out, mutated["batch_stats"])

    (_, (jout, jstats)), jgrads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], variables["batch_stats"], jbatch)

    model = _port(cfg, variables)
    tbatch = synthetic.to_device(batch, "cpu")
    with torch.no_grad():
        teval = model(tbatch, train=False)
    state = create_train_state(cfg, model)
    tmetrics = make_mask_votenet_step(cfg, state)(tbatch, LR, BN_MOMENTUM)
    return dict(
        cfg=cfg, batch=batch, variables=variables,
        jeval={k: np.asarray(v) for k, v in jeval.items()},
        teval={k: v.numpy() for k, v in teval.items()
               if isinstance(v, torch.Tensor)},
        jmetrics={k: float(jout[k]) for k in MVN_REPORT_KEYS},
        tmetrics={k: v for k, v in tmetrics.items()},
        jgrads=named_from_flax(jgrads),
        tgrads={n: p.grad.detach().clone()
                for n, p in model.named_parameters()},
        jstats=state_dict_from_flax({}, jstats),
        tstats={k: v.clone() for k, v in model.state_dict().items()
                if "running_" in k},
        model=model, state=state)


def _close_to_scale(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-6),
                               err_msg=what)


# --- the model --------------------------------------------------------------
def test_forward_matches_jax(runs):
    got, want = runs["teval"], runs["jeval"]
    assert got["center"].shape == (B, 1, 3)
    assert got["size_scores"].shape == (B, 1, 18)
    assert got["size_residuals"].shape == (B, 1, 18, 3)
    assert "objectness_scores" not in got          # no objectness head
    for k in INDEX_KEYS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in FLOAT_KEYS:
        _close_to_scale(got[k], want[k], 1e-4, k)


def test_forward_without_multiview_matches_jax():
    # sa1 over 5 input channels (normal, height, mask) is not gather-lean:
    # it gathers the raw points and features
    kw = dict(CFG, use_multiview=False)
    cfg = ModelConfig(**kw)
    batch = _batch(cfg, seed=5)
    jmodel, jbatch, variables = _jax_model(kw, batch)
    want = jax.jit(jmodel.apply, static_argnames=("train",))(
        variables, jbatch, train=False)
    model = _port(cfg, variables)
    assert not model.backbone_net.sa1.gather_lean
    assert model.proposal.vote_aggregation.gather_lean
    with torch.no_grad():
        got = model(synthetic.to_device(batch, "cpu"), train=False)
    for k in INDEX_KEYS:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    for k in FLOAT_KEYS:
        _close_to_scale(got[k].numpy(), np.asarray(want[k]), 1e-4, k)


def test_aggregation_is_one_ball_of_512_over_all_votes(runs):
    model = runs["model"]
    agg = model.proposal.vote_aggregation
    assert (agg.npoint, agg.radius, agg.nsample) == (1, 5.0, 512)
    sa1 = model.backbone_net.sa1
    assert sa1.gather_lean and sa1.leaf_inputs       # 133 feature channels
    assert model.backbone_net.sa1.mlp.dense_0.in_features == 3 + 133
    np.testing.assert_array_equal(runs["teval"]["aggregated_vote_inds"], 0)


# --- the losses -------------------------------------------------------------
PREDICTIONS = ("vote_xyz", "center", "size_scores",
               "size_residuals_normalized", "sem_cls_scores")


def _loss_data(seed=0):
    rs = np.random.RandomState(seed)
    cfg = ModelConfig(**CFG)
    d = synthetic.make_mask_votenet_batch(cfg, B, num_objects=4, seed=seed)
    f = lambda *shape: rs.randn(*shape).astype(np.float32)
    S = 32
    d["seed_inds"] = np.stack([rs.permutation(cfg.num_points)[:S]
                               for _ in range(B)]).astype(np.int32)
    d["seed_xyz"] = np.take_along_axis(
        d["point_clouds"][..., :3], d["seed_inds"][..., None], 1)
    d["vote_xyz"] = d["seed_xyz"] + 0.2 * f(B, S, 3)
    d["center"] = d["center_label"] + 0.3 * f(B, 1, 3)
    d["center"][0] = d["center_label"][0]          # a zero distance
    d["size_scores"] = f(B, 1, 18)
    d["size_residuals_normalized"] = 0.5 * f(B, 1, 18, 3)
    d["size_residuals"] = (d["size_residuals_normalized"]
                           * SCANNET_MEAN_SIZE_ARR[None, None])
    d["sem_cls_scores"] = f(B, 1, 18)
    # one scene whose classes are right
    d["sem_cls_scores"][1, 0, d["sem_cls_label"][1, 0]] += 10.0
    d["size_scores"][1, 0, d["size_class_label"][1, 0]] += 10.0
    return d


def _grad_check(jfn, tfn, keys):
    d = _loss_data()
    jd = {k: jnp.asarray(v) for k, v in d.items()}
    td = {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}
    for k in keys:
        td[k].requires_grad_(True)

    def jtotal(preds):
        out = jfn({**jd, **preds})
        return sum((i + 1.0) * o for i, o in enumerate(out)), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(jtotal, has_aux=True))(
        {k: jd[k] for k in keys})
    tout = tfn(td)
    assert len(tout) == len(jout)
    for g, w in zip(tout, jout):
        g, w = float(g.detach()), float(w)
        assert abs(g - w) <= 1e-5 * max(abs(w), 1e-2), (g, w)
    sum((i + 1.0) * o for i, o in enumerate(tout)).backward()
    for k in keys:
        want = np.asarray(jgrads[k])
        assert np.abs(want).max() > 0, k
        np.testing.assert_allclose(td[k].grad.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(), err_msg=k)
    return tout


def test_mask_box_loss_matches_jax():
    out = _grad_check(jmask_losses.compute_mask_box_loss,
                      mask_losses.compute_mask_box_loss,
                      ["center", "size_scores", "size_residuals_normalized",
                       "sem_cls_scores"])
    assert 0 < float(out[4]) < 1                   # sem_cls_acc: one right


LOSS_KEYS = ("loss", "vote_loss", "box_loss", "center_loss", "size_cls_loss",
             "size_reg_loss", "sem_cls_loss")


def test_total_mask_votenet_loss_matches_jax():
    # the loss terms with their gradients; the two metrics (sem_cls_acc,
    # miou) by value: no loss reaches them, and the port's miou carries no
    # gradient
    def jfn(d):
        out = jmask_losses.get_mask_votenet_loss(d)
        return tuple(out[k] for k in LOSS_KEYS)

    def tfn(d):
        out = mask_losses.get_mask_votenet_loss(d)
        return tuple(out[k] for k in LOSS_KEYS)

    _grad_check(jfn, tfn, list(PREDICTIONS))
    d = _loss_data()
    want = jax.jit(jmask_losses.get_mask_votenet_loss)(
        {k: jnp.asarray(v) for k, v in d.items()})
    got = mask_losses.get_mask_votenet_loss(
        {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()})
    assert set(MVN_REPORT_KEYS) <= set(got)
    for k in ("sem_cls_acc", "miou", "objectness_loss", "heading_cls_loss",
              "heading_reg_loss"):
        assert float(got[k]) == float(want[k]), k
    assert 0 < float(got["miou"]) < 1


def test_miou_matches_jax_and_has_no_gradient():
    d = _loss_data(seed=2)
    want = float(jax.jit(jmask_losses.compute_miou)(
        {k: jnp.asarray(v) for k, v in d.items()}))
    td = {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}
    td["center"].requires_grad_(True)
    got = mask_losses.compute_miou(td)
    assert not got.requires_grad
    assert float(got) == want                      # the IoU rounds as XLA


# --- the train step ---------------------------------------------------------
@pytest.mark.parametrize("key", MVN_REPORT_KEYS)
def test_train_step_metric_matches_jax(runs, key):
    got, want = float(runs["tmetrics"][key]), runs["jmetrics"][key]
    assert runs["tmetrics"][key].shape == ()
    rel = 2.5e-5 if key == "loss" else 1e-4     # see the module docstring
    assert abs(got - want) <= rel * max(abs(want), 0.1), (got, want)


def test_train_step_gradients_match_jax(runs):
    jg, tg = runs["jgrads"], runs["tgrads"]
    assert set(jg) == set(tg)
    # the voting head's conv1 and conv2 biases feed a batch norm, which
    # subtracts them out again: their gradient is 0 up to rounding in both
    # packages, and is held to 1e-8 of the whole gradient's largest entry
    scale = max(float(np.abs(g.numpy()).max()) for g in jg.values())
    residue = ("vgen.conv1.bias", "vgen.conv2.bias")
    for name in residue:
        for g in (jg[name], tg[name]):
            assert float(g.abs().max()) <= 1e-8 * scale, name
    worst, rel = [], []
    for name in sorted(set(jg) - set(residue)):
        want, got = jg[name].numpy(), tg[name].numpy()
        assert got.shape == want.shape, name
        err = np.abs(got - want).max()
        if err > 1e-2 * np.abs(want).max() + 1e-6:
            worst.append((name, float(err), float(np.abs(want).max())))
        if np.abs(want).max() > 1e-5:
            rel.append(err / np.abs(want).max())
    assert not worst, worst
    assert np.median(rel) <= 1e-3, np.median(rel)
    for part in ("backbone_net.sa1", "backbone_net.fp2", "vgen",
                 "proposal.vote_aggregation", "proposal.conv3"):
        assert any(n.startswith(part) and np.abs(g.numpy()).max() > 0
                   for n, g in tg.items()), part


def test_train_step_batch_stats_match_jax(runs):
    assert set(runs["jstats"]) == set(runs["tstats"])
    for k, want in runs["jstats"].items():
        np.testing.assert_allclose(runs["tstats"][k].numpy(), want.numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    assert runs["state"].step == 1


# --- the dataset ------------------------------------------------------------
SCENES = ["scene0000_00", "scene0001_00"]


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    path = tmp_path_factory.mktemp("mask_scannet")
    rng = np.random.RandomState(0)
    for s in SCENES:
        make_fixture_scene(str(path), s, rng, n_points=1800, n_obj=3)
    scanrefer = [{"scene_id": s, "object_id": str(o), "object_name": "chair",
                  "ann_id": str(a), "token": ["a", "chair"]}
                 for s in SCENES for o in range(3) for a in range(2)]
    return str(path), scanrefer, make_fixture_glove(["a", "chair"])


def _mask_pair(scenes, **kw):
    path, scanrefer, glove = scenes
    args = dict(scannet_data_dir=path, glove_path="", glove=glove,
                num_points=512, use_height=True, use_color=True,
                use_normal=True)
    args.update(kw)
    return (jmask_dataset.MaskScannetReferenceDataset(scanrefer, SCENES,
                                                      **args),
            mask_dataset.MaskScannetReferenceDataset(scanrefer, SCENES,
                                                     **args))


def _equal(a, b, what):
    assert set(a) == set(b), what
    for k in a:
        if k == "load_time":
            continue
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, (what, k)
        np.testing.assert_array_equal(x, y, err_msg=f"{what}: {k}")


@pytest.mark.parametrize("kw", [
    dict(augment=False), dict(augment=True),
    dict(augment=True, use_color=False, use_normal=False)])
def test_mask_dataset_items_match_jax(scenes, kw):
    jds, ds = _mask_pair(scenes, **kw)
    assert len(ds) == len(jds) == 6                # (scene, object) pairs
    for i in range(len(ds)):
        got = ds.__getitem__(i, np.random.RandomState(i))
        _equal(jds.__getitem__(i, np.random.RandomState(i)), got,
               f"item {i}")
        mask = got["point_clouds"][:, -1]
        assert mask.sum() >= 512 // 2              # the biased sampling
        pts = got["point_clouds"][mask == 1, :3]
        centre = 0.5 * (pts.min(0) + pts.max(0))
        np.testing.assert_allclose(got["vote_label"][:, :3]
                                   + got["point_clouds"][:, :3],
                                   np.broadcast_to(centre, (512, 3)),
                                   atol=1e-5)


def test_mask_loader_batches_match_jax(scenes):
    jds, ds = _mask_pair(scenes, augment=True)
    jl = jdataset.Loader(jds, batch_size=2, shuffle=True, seed=3,
                         num_workers=2)
    tl = dataset.Loader(ds, batch_size=2, shuffle=True, seed=3,
                        num_workers=2)
    for epoch in range(2):
        got, want = list(tl), list(jl)
        assert len(got) == len(want) == 3
        for b, (x, y) in enumerate(zip(want, got)):
            _equal(x, y, f"epoch {epoch} batch {b}")
    jl.close()
    tl.close()


def test_mask_dataset_refuses_an_object_without_points(scenes):
    path, scanrefer, glove = scenes
    entry = dict(scanrefer[0], object_id="7")
    ds = mask_dataset.MaskScannetReferenceDataset(
        [entry], SCENES[:1], scannet_data_dir=path, glove_path="",
        glove=glove, num_points=512, use_height=True)
    with pytest.raises(ValueError, match="instance label 8"):
        ds.__getitem__(0, np.random.RandomState(0))


# --- weights ----------------------------------------------------------------
def test_pth_layout_both_ways_matches_jax(runs, tmp_path):
    params = jax.tree.map(np.asarray, runs["variables"]["params"])
    stats = jax.tree.map(np.asarray, runs["variables"]["batch_stats"])
    want = jconvert.export_votenet_checkpoint(params, stats)
    model = _port(runs["cfg"], runs["variables"])
    got = convert.reference_from_state_dict(model.state_dict())
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
    assert convert.is_detection_only(got)

    path = tmp_path / "mvn.pth"
    torch.save(want, path)
    sd = convert.state_dict_from_reference(str(path))
    back = MaskVoteNet(runs["cfg"], device="cpu", seed=9)
    back.load_state_dict(sd, strict=True)
    own = model.state_dict()
    assert all(torch.equal(back.state_dict()[k], own[k]) for k in own)
    # and the JAX converter reads the port's export into the same trees
    torch.save(got, path)
    jp, js = jconvert.convert_votenet_checkpoint(str(path))
    want_p, got_p = named_from_flax(params), named_from_flax(jp)
    assert set(got_p) == set(want_p)
    assert all(torch.equal(got_p[k], want_p[k]) for k in want_p)
    want_s, got_s = state_dict_from_flax({}, stats), state_dict_from_flax({}, js)
    assert set(got_s) == set(want_s)
    assert all(torch.equal(got_s[k], want_s[k]) for k in want_s)


def test_mask_votenet_weights_do_not_mount_into_a_capnet(runs):
    from scan2cap_torch.models import CapNet
    sd = convert.reference_from_state_dict(runs["model"].state_dict())
    capnet = CapNet(ModelConfig(num_points=1024, sa_npoints=(64, 32, 16, 8),
                                num_proposals=8, use_normal=True,
                                use_multiview=True, no_caption=True),
                    device="cpu")
    # the mask channel widens sa1, the one-proposal head narrows conv3
    with pytest.raises(RuntimeError, match="size mismatch"):
        convert.mount_detection_weights(capnet, sd)


# --- the entry point ----------------------------------------------------------
TINY = ["--batch_size", "2", "--num_points", "2048", "--verbose", "1",
        "--device", "cpu"]


@pytest.fixture
def cli_env(tmp_path, monkeypatch):
    data = write_cli_data(tmp_path, np.random.RandomState(0))
    monkeypatch.setenv("SCAN2CAP_DATA", str(data))
    monkeypatch.setenv("SCAN2CAP_OUTPUT", str(tmp_path / "outputs"))
    monkeypatch.setenv("SCAN2CAP_TEST_TINY", "1")
    return tmp_path / "outputs"


def test_train_maskvotenet_one_epoch(cli_env):
    solver = mvncli.main(TINY + ["--use_normal", "--epoch", "1", "--tag",
                                 "mvn"])
    run = next(p for p in cli_env.iterdir() if p.name.endswith("_MVN"))
    info = json.loads((run / "info.json").read_text())
    assert info["device"] == "cpu" and info["num_train"] == 4
    log = (run / "log.txt").read_text()
    assert "epoch 1 starting..." in log and "loss" in log
    stats = json.loads((run / "train_stats.json").read_text())
    assert stats["steps"] == 2
    assert all(np.isfinite(stats["epochs"][0]["losses"]))
    assert not (run / "ckpt" / "best.pt").exists()     # no eval pass
    ckpt = CheckpointIO(str(run / "ckpt"))
    resume = ckpt.restore("resume")
    assert resume["epoch"] == 0 and resume["step"] == 2
    last = ckpt.restore("last")["model"]
    model = MaskVoteNet(solver.model.cfg, device="cpu", seed=1)
    model.load_state_dict(last, strict=True)
    assert model.cfg.sa_npoints == (128, 64, 32, 16)
    assert model.cfg.input_feature_dim + 1 == 5        # normal, height, mask
    back = convert.state_dict_from_reference(
        convert.reference_from_state_dict(last))
    assert set(back) == set(last)
    assert all(torch.equal(back[k], last[k]) for k in last)


def test_train_maskvotenet_refuses_mesh(cli_env):
    # once refused: --mesh 2,1 runs the epoch over two ranks (gloo), its
    # first loss the one process's within 2e-3
    losses = {}
    for tag, extra in (("one", []), ("two", ["--mesh", "2,1"])):
        mvncli.main(TINY + ["--epoch", "1", "--tag", tag] + extra)
        run = next(p for p in cli_env.iterdir()
                   if p.name.endswith("_" + tag.upper()))
        info = json.loads((run / "info.json").read_text())
        assert info["mesh"] == (extra[1] if extra else None)
        losses[tag] = json.loads((run / "train_stats.json").read_text())[
            "epochs"][0]["losses"][0]
    assert abs(losses["two"] - losses["one"]) <= 2e-3 * abs(losses["one"])
    assert mvncli.build_parser().parse_args([]).device == "cuda"
