"""The port's pretrained-feature track against the JAX package's, on the
CPU.

The caption-only CapNet at a small size (hidden 32, embedding 16, a
vocabulary of 30, captions of up to 10 words) over the launch script's box
counts (128 GT boxes in "gt" mode, 256 stored proposals in "votenet"
mode), in both modes, with 0 and 2 graph steps and both caption heads: the
JAX model's initial weights carried with ``convert.state_dict_from_flax``,
the same seeded numpy batch (``data.synthetic.make_pretrained_batch``)
through jitted JAX and the port.

Tolerances:
* the forward: floats within 1e-4 of the tensor's largest magnitude;
  tokens, neighbour indices and masks exact;
* each loss, and its gradient with respect to every prediction it reads:
  1e-5 (as ``tests/test_torch_losses.py``);
* one train step: every reported metric within 1e-4 relative (1e-5
  absolute below 0.1), each parameter's gradient within
  ``1e-2 * max|g| + 1e-6`` with a median of at most 1e-3 over the tensors
  (the gates of ``tests/test_torch_train.py``);
* dataset items, Loader batches, eval candidates and the extractor's ids,
  keys and corners: exact; its features 1e-4.
"""

import os

import h5py
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests.test_dataset import make_fixture_glove

from scan2cap_tpu.config import ModelConfig as JModelConfig
from scan2cap_tpu.data import dataset as jdataset
from scan2cap_tpu.data import dataset_pretrained as jpretrained
from scan2cap_tpu.eval import eval_pretrained as jeval_pretrained
from scan2cap_tpu.losses import pretrained as jlosses
from scan2cap_tpu.models.capnet_pretrained import (
    CapNetPretrained as JCapNetPretrained)

from scan2cap_torch.config import ModelConfig
from scan2cap_torch.convert import named_from_flax, state_dict_from_flax
from scan2cap_torch.data import dataset, synthetic
from scan2cap_torch.data import dataset_pretrained as pretrained
from scan2cap_torch.data.feature_store import FeatureStoreWriter
from scan2cap_torch.eval import eval_pretrained
from scan2cap_torch.losses import pretrained as losses
from scan2cap_torch.models.capnet_pretrained import CapNetPretrained
from scan2cap_torch.scripts import train_pretrained as precli
from scan2cap_torch.train.step import (PRETRAINED_REPORT_KEYS,
                                       create_train_state, make_eval_step,
                                       make_pretrained_step)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V = 30
SMALL = dict(hidden_size=32, emb_size=16, max_des_len=10, num_locals=4,
             min_iou=0.25)
FLOAT_KEYS = ("lang_cap", "topdown_attn", "bbox_feature", "edge_feature",
              "edge_orientations", "edge_distances", "pred_ious")
EXACT_KEYS = ("good_bbox_masks", "valid_masks", "edge_nbr_idx", "edge_mask",
              "adjacent_mat", "topdown_attn_slots")
K_OF = {"gt": 128, "votenet": 256}


def _cfg(mode, graph_steps, topdown, **kw):
    return dict(SMALL, num_proposals=K_OF[mode], num_graph_steps=graph_steps,
                use_topdown=topdown, use_relation=topdown and graph_steps > 0,
                use_orientation=graph_steps > 0, **kw)


def _batch(cfg_kw, mode, seed=0):
    cfg = ModelConfig(**cfg_kw)
    vocab = synthetic.make_vocab(num_vocabs=V, emb_size=cfg.emb_size)
    return synthetic.make_pretrained_batch(cfg, mode, batch_size=2,
                                           vocab=vocab, seed=seed)


def _close_to_scale(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-6),
                               err_msg=what)


_RUNS = {}


def _model_run(mode, graph_steps, topdown):
    """The JAX and the port model on one batch: the teacher-forced forward
    and the greedy eval decode (cached per configuration)."""
    key = (mode, graph_steps, topdown)
    if key in _RUNS:
        return _RUNS[key]
    kw = _cfg(mode, graph_steps, topdown)
    batch = _batch(kw, mode)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = JCapNetPretrained(JModelConfig(**kw), mode=mode, num_vocabs=V)
    static = ("use_tf", "is_eval", "train")
    variables = jax.jit(jmodel.init, static_argnames=static)(
        jax.random.PRNGKey(0), jbatch, use_tf=True, is_eval=False,
        train=False)
    apply = jax.jit(jmodel.apply, static_argnames=static)
    jtf = apply(variables, jbatch, use_tf=True, is_eval=False, train=True)
    jev = apply(variables, jbatch, use_tf=False, is_eval=True, train=False)

    cfg = ModelConfig(**kw)
    model = CapNetPretrained(cfg, mode=mode, num_vocabs=V, device="cpu",
                             seed=3)
    model.load_state_dict(state_dict_from_flax(
        variables["params"], variables.get("batch_stats", {})), strict=True)
    tbatch = synthetic.to_device(batch, "cpu")
    with torch.no_grad():
        ttf = model(tbatch, use_tf=True, is_eval=False, train=True)
    tev = make_eval_step(cfg, model, detection_loss=False, keep_attn=True)(
        tbatch)
    np_ = lambda d: {k: np.asarray(v) for k, v in d.items()
                     if isinstance(v, (jax.Array, np.ndarray))}
    tn = lambda d: {k: v.numpy() for k, v in d.items()
                    if isinstance(v, torch.Tensor)}
    run = dict(cfg=cfg, batch=batch, variables=variables, model=model,
               jtf=np_(jtf), ttf=tn(ttf), jev=np_(jev), tev=tn(tev))
    _RUNS[key] = run
    return run


CONFIGS = [(m, g, t) for m in ("gt", "votenet") for g in (0, 2)
           for t in (True, False)]


# --- the model --------------------------------------------------------------
@pytest.mark.parametrize("mode,graph_steps,topdown", CONFIGS)
def test_teacher_forced_forward_matches_jax(mode, graph_steps, topdown):
    run = _model_run(mode, graph_steps, topdown)
    got, want = run["ttf"], run["jtf"]
    assert got["lang_cap"].shape == (2, SMALL["max_des_len"] + 1, V)
    for k in FLOAT_KEYS:
        if k in want:
            _close_to_scale(got[k], want[k], 1e-4, k)
    for k in EXACT_KEYS:
        if k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if mode == "gt" and topdown:
        # the oracle: every target is good with IoU 1, not a gated mean
        assert got["good_bbox_masks"].all() and float(got["pred_ious"]) == 1.0
    assert (graph_steps > 0) == ("edge_feature" in got)


@pytest.mark.parametrize("mode,graph_steps,topdown", CONFIGS)
def test_greedy_decode_matches_jax(mode, graph_steps, topdown):
    run = _model_run(mode, graph_steps, topdown)
    got, want = run["tev"], run["jev"]
    K = K_OF[mode]
    assert got["lang_cap"].shape == (2, K, SMALL["max_des_len"] - 1)
    assert got["lang_cap"].dtype == np.int32
    np.testing.assert_array_equal(got["lang_cap"], want["lang_cap"])
    if topdown:
        _close_to_scale(got["topdown_attn"], want["topdown_attn"], 1e-4,
                        "topdown_attn")
        np.testing.assert_array_equal(got["topdown_attn_slots"],
                                      want["topdown_attn_slots"])
    # more than one distinct caption: the decode is not degenerate
    assert len({tuple(r) for r in got["lang_cap"].reshape(-1, 9)}) > 1


def test_oracle_target_is_bbox_idx():
    run = _model_run("gt", 2, True)
    # each target's local mask holds its own box, and its first attention
    # step attends only within its num_locals locals
    valid = run["ttf"]["valid_masks"]
    idx = run["batch"]["bbox_idx"]
    assert all(valid[b, idx[b]] == 1 for b in range(2))
    assert (valid.sum(-1) == SMALL["num_locals"]).all()


def test_mode_sets_the_box_count_and_head():
    cfg = ModelConfig(**_cfg("votenet", 0, True))
    assert CapNetPretrained(cfg, "votenet", V, device="cpu").num_proposals \
        == 256
    model = CapNetPretrained(ModelConfig(**_cfg("gt", 0, True)), "gt", V,
                             device="cpu")
    assert model.num_proposals == 128 and model.caption.use_oracle
    assert not CapNetPretrained(cfg, "votenet", V,
                                device="cpu").caption.use_oracle
    with pytest.raises(ValueError, match="mode"):
        CapNetPretrained(cfg, "scene", V, device="cpu")


# --- the losses -------------------------------------------------------------
def _loss_data(mode, seed=0):
    """Predictions and labels of a (B=2, K=16, L=4) pretrained batch."""
    rs = np.random.RandomState(seed)
    kw = dict(_cfg(mode, 2, True), num_proposals=16)
    cfg = ModelConfig(**kw)
    d = synthetic.make_pretrained_batch(
        cfg, mode, 2, synthetic.make_vocab(V, cfg.emb_size), seed=seed,
        max_gt=8)
    B, K, L, T = 2, 16, 4, cfg.max_des_len + 1
    d["lang_cap"] = rs.randn(B, T, V).astype(np.float32)
    d["good_bbox_masks"] = np.array([True, False])
    nbr = np.stack([np.stack([rs.permutation(K)[:L] for _ in range(K)])
                    for _ in range(B)]).astype(np.int32)
    d["edge_nbr_idx"] = nbr
    d["edge_mask"] = (rs.rand(B, K, L) < 0.8).astype(np.float32)
    d["edge_orientations"] = rs.randn(B, K, L, cfg.num_bins).astype(np.float32)
    d["edge_distances"] = rs.randn(B, K, L).astype(np.float32)
    return {k: v for k, v in d.items() if k != "glove_emb_table"}


def _grad_check(jfn, tfn, d, keys):
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


def test_cap_loss_gt_matches_jax():
    out = _grad_check(
        lambda d: jlosses.compute_cap_loss_gt(d),
        lambda d: losses.compute_cap_loss_gt(d), _loss_data("gt"),
        ["lang_cap"])
    assert float(out[0].detach()) > 0 and 0 <= float(out[1]) <= 1


LOSS_KEYS = ("loss", "cap_loss", "ori_loss", "dist_loss")


@pytest.mark.parametrize("mode", ["gt", "votenet"])
@pytest.mark.parametrize("orientation,distance", [(False, False),
                                                  (True, False),
                                                  (True, True)])
def test_pretrained_loss_matches_jax(mode, orientation, distance):
    kw = dict(mode=mode, orientation=orientation, distance=distance)
    keys = ["lang_cap"] + (["edge_orientations"] if orientation else []) \
        + (["edge_distances"] if distance else [])

    def jfn(d):
        out = jlosses.get_pretrained_loss(d, **kw)
        return tuple(out[k] for k in LOSS_KEYS)

    def tfn(d):
        out = losses.get_pretrained_loss(d, **kw)
        return tuple(out[k] for k in LOSS_KEYS)

    d = _loss_data(mode, seed=1)
    _grad_check(jfn, tfn, d, keys)
    want = jax.jit(lambda x: jlosses.get_pretrained_loss(x, **kw))(
        {k: jnp.asarray(v) for k, v in d.items()})
    got = losses.get_pretrained_loss(
        {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}, **kw)
    assert set(PRETRAINED_REPORT_KEYS) <= set(got)
    for k in ("cap_acc", "ori_acc"):
        assert abs(float(got[k]) - float(want[k])) <= 1e-6, k
    if orientation:
        assert float(got["ori_loss"]) > 0
        np.testing.assert_array_equal(got["object_assignment"].numpy(),
                                      np.asarray(want["object_assignment"]))


# --- one train step ---------------------------------------------------------
LR = 1e-3


def _step_runs(mode):
    kw = _cfg(mode, 2, True)
    batch = _batch(kw, mode, seed=5)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = JCapNetPretrained(JModelConfig(**kw), mode=mode, num_vocabs=V)
    static = ("use_tf", "is_eval", "train")
    variables = jax.jit(jmodel.init, static_argnames=static)(
        jax.random.PRNGKey(1), jbatch, use_tf=True, is_eval=False,
        train=False)

    def loss_fn(params):
        out = jmodel.apply({"params": params}, jbatch, use_tf=True,
                           is_eval=False, train=True)
        out = jlosses.get_pretrained_loss(out, mode=mode, orientation=True)
        return out["loss"], {k: out[k] for k in PRETRAINED_REPORT_KEYS}

    (_, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])
    cfg = ModelConfig(**kw)
    model = CapNetPretrained(cfg, mode=mode, num_vocabs=V, device="cpu")
    model.load_state_dict(state_dict_from_flax(variables["params"], {}),
                          strict=True)
    state = create_train_state(cfg, model)
    step = make_pretrained_step(cfg, state, mode, orientation=True)
    tmetrics = step(synthetic.to_device(batch, "cpu"), LR, 0.1)
    return dict(jmetrics={k: float(v) for k, v in jmetrics.items()},
                tmetrics={k: float(v) for k, v in tmetrics.items()},
                jgrads=named_from_flax(jgrads),
                tgrads={n: p.grad.detach().clone()
                        for n, p in model.named_parameters()},
                state=state)


@pytest.fixture(scope="module", params=["gt", "votenet"])
def step_runs(request):
    return _step_runs(request.param)


def test_train_step_metrics_match_jax(step_runs):
    got, want = step_runs["tmetrics"], step_runs["jmetrics"]
    assert set(got) == set(want) == set(PRETRAINED_REPORT_KEYS)
    for k in PRETRAINED_REPORT_KEYS:
        assert abs(got[k] - want[k]) <= 1e-4 * max(abs(want[k]), 0.1), \
            (k, got[k], want[k])
    assert got["cap_loss"] > 0 and got["ori_loss"] > 0
    assert step_runs["state"].step == 1


def test_train_step_gradients_match_jax(step_runs):
    jg, tg = step_runs["jgrads"], step_runs["tgrads"]
    assert set(jg) == set(tg)
    worst, rel = [], []
    for name in sorted(jg):
        want, got = jg[name].numpy(), tg[name].numpy()
        assert got.shape == want.shape, name
        err = np.abs(got - want).max()
        if err > 1e-2 * np.abs(want).max() + 1e-6:
            worst.append((name, float(err), float(np.abs(want).max())))
        if np.abs(want).max() > 1e-5:
            rel.append(err / np.abs(want).max())
    assert not worst, worst
    assert np.median(rel) <= 1e-3, np.median(rel)
    for part in ("graph.gc_0", "graph.edge_predict", "caption.classifier",
                 "caption.map_feat", "caption.recurrent_cell_1"):
        assert any(n.startswith(part) and np.abs(g.numpy()).max() > 0
                   for n, g in tg.items()), part


# --- the datasets -----------------------------------------------------------
SCENES = ["scene0000_00", "scene0001_00", "scene0002_00"]
WORDS = ["a", "red", "chair", "by", "the", "table"]
# boxes a scene: scene 2 holds more than the test's K of 8 (truncation)
BOXES = {"scene0000_00": 5, "scene0001_00": 3, "scene0002_00": 11}


def _databases(root, rs, epochs=3):
    """The same GT and VoteNet databases as HDF5 (for the JAX package) and
    as the port's store, in the JAX extractors' dtypes."""
    gt, vn = {}, {}
    for s, m in BOXES.items():
        ids = rs.permutation(20)[:m]
        for e in range(epochs):
            corners = rs.randn(m, 8, 3).astype(np.float32)
            gt[f"{e}|{s}_gt_ids"] = ids.astype(np.int64)
            gt[f"{e}|{s}_features"] = rs.randn(m, 128).astype(np.float32)
            gt[f"{e}|{s}_bbox_corners"] = corners
            gt[f"{e}|{s}_gt_corners"] = corners
        p = 2 * m
        vn[f"0|{s}_object_ids"] = rs.choice(ids, p).astype(np.int32)
        vn[f"0|{s}_features"] = rs.randn(p, 128).astype(np.float32)
        vn[f"0|{s}_bbox_corners"] = rs.randn(p, 8, 3).astype(np.float32)
        vn[f"0|{s}_gt_ids"] = ids.astype(np.int32)
        vn[f"0|{s}_gt_corners"] = rs.randn(m, 8, 3).astype(np.float32)
    paths = {}
    for name, arrays in (("gt", gt), ("votenet", vn)):
        h5 = str(root / f"{name}.hdf5")
        with h5py.File(h5, "w") as db:
            for k, v in arrays.items():
                db[k] = v
        npz = str(root / f"{name}.npz")
        with FeatureStoreWriter(npz) as db:
            for k, v in arrays.items():
                db[k] = v
        paths[name] = (h5, npz)
    return paths, gt, vn


@pytest.fixture(scope="module")
def databases(tmp_path_factory):
    root = tmp_path_factory.mktemp("pretrained_db")
    rs = np.random.RandomState(0)
    paths, gt, vn = _databases(root, rs)
    scanrefer = []
    for s in SCENES:
        ids = gt[f"0|{s}_gt_ids"]
        for o in list(ids[:3]) + [99]:       # 99: in no database
            scanrefer.append({"scene_id": s, "object_id": str(int(o)),
                              "object_name": "chair", "ann_id": "0",
                              "token": list(rs.choice(WORDS, 5))})
    rotations = {s: {str(int(o)): np.eye(3).tolist()
                     for o in list(gt[f"0|{s}_gt_ids"][::2]) + [0]}
                 for s in SCENES}
    return dict(paths=paths, scanrefer=scanrefer, rotations=rotations,
                glove=make_fixture_glove(WORDS), gt=gt, vn=vn, root=root)


def _ds_pair(databases, mode, split="train", **kw):
    h5, npz = databases["paths"][mode]
    jcls = (jpretrained.PretrainedGTDataset if mode == "gt"
            else jpretrained.PretrainedVoteNetDataset)
    tcls = (pretrained.PretrainedGTDataset if mode == "gt"
            else pretrained.PretrainedVoteNetDataset)
    args = dict(split=split, glove=databases["glove"],
                scan2cad_rotation=databases["rotations"], K=8, **kw)
    return (jcls(databases["scanrefer"], h5, **args),
            tcls(databases["scanrefer"], npz, **args))


def _equal(a, b, what):
    assert set(a) == set(b), what
    for k in a:
        if k == "load_time":
            continue
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, (what, k)
        np.testing.assert_array_equal(x, y, err_msg=f"{what}: {k}")


@pytest.mark.parametrize("mode", ["gt", "votenet"])
@pytest.mark.parametrize("split", ["train", "val"])
def test_dataset_items_match_jax(databases, mode, split):
    jds, ds = _ds_pair(databases, mode, split)
    assert len(ds) == len(jds) == 12 and ds.num_vocabs == jds.num_vocabs
    for i in range(len(ds)):
        for seed in (i, 100 + i):
            want = jds.__getitem__(i, np.random.RandomState(seed))
            got = ds.__getitem__(i, np.random.RandomState(seed))
            _equal(want, got, f"{mode} {split} item {i}")
            assert 0 < got["bbox_mask"].sum() <= 8
            rot_mask = got["scene_object_rotation_masks"]
            assert not rot_mask[got["bbox_mask"] == 0].any()   # pads never


def test_gt_dataset_caps_the_epoch_draw_to_the_database(databases):
    jds, ds = _ds_pair(databases, "gt")
    assert ds.num_preset_epochs == jds.num_preset_epochs == 3
    drawn = set()
    for seed in range(40):
        item = ds.__getitem__(0, np.random.RandomState(seed))
        feats = item["bbox_feature"][:item["bbox_mask"].sum()]
        drawn |= {e for e in range(3) if np.array_equal(
            feats, databases["gt"][f"{e}|{SCENES[0]}_features"][:8])}
    assert drawn == {0, 1, 2}
    _, val = _ds_pair(databases, "gt", split="val")
    assert val.num_preset_epochs == 100          # val reads epoch 0 only
    _, fewer = _ds_pair(databases, "gt", num_preset_epochs=2)
    assert fewer.num_preset_epochs == 2


@pytest.mark.parametrize("mode", ["gt", "votenet"])
def test_loader_batches_match_jax(databases, mode):
    jds, ds = _ds_pair(databases, mode)
    jl = jdataset.Loader(jds, batch_size=4, shuffle=True, seed=3,
                         num_workers=4)
    tl = dataset.Loader(ds, batch_size=4, shuffle=True, seed=3,
                        num_workers=4, reuse_buffers=True)
    for epoch in range(2):
        want = list(jl)
        got = [{k: v.copy() for k, v in b.items()} for b in tl]
        assert len(got) == len(want) == 3
        for b, (x, y) in enumerate(zip(want, got)):
            _equal(x, y, f"{mode} epoch {epoch} batch {b}")
    jl.close()
    tl.close()


def test_votenet_item_builds_the_fill_objectness(databases):
    _, ds = _ds_pair(databases, "votenet")
    item = ds.__getitem__(8)                      # scene 2: 22 proposals
    np.testing.assert_array_equal(item["bbox_mask"], 1)
    assert (item["objectness_scores"][:, 1] == np.float32(1 - 1e-8)).all()
    item = ds.__getitem__(4)                      # scene 1: 6 proposals
    assert item["bbox_mask"].sum() == 6
    np.testing.assert_array_equal(item["objectness_scores"][6:],
                                  np.float32(1e-8))


# --- eval -------------------------------------------------------------------
ORGANIZED_NAME = "chair"


def _organized(scanrefer):
    organized = {}
    for e in scanrefer:
        organized.setdefault(e["scene_id"], {}).setdefault(
            e["object_id"], {})[e["ann_id"]] = e
    return organized


@pytest.mark.parametrize("mode", ["gt", "votenet"])
def test_feed_pretrained_cap_matches_jax(databases, mode):
    # the store's boxes, and in votenet mode reference boxes that overlap
    # some proposals: each scene's proposals are its GT boxes, shifted
    root = databases["root"]
    rs = np.random.RandomState(4)
    arrays = dict(databases["gt" if mode == "gt" else "vn"])
    if mode == "votenet":
        for s in SCENES:
            gt = rs.uniform(-3, 3, (BOXES[s], 1, 3)) + 0.4 * rs.randn(
                BOXES[s], 8, 3)
            arrays[f"0|{s}_gt_corners"] = gt.astype(np.float32)
            ids = arrays[f"0|{s}_gt_ids"]
            prop = np.concatenate([gt + rs.uniform(-0.1, 0.1, (len(gt), 1, 3)),
                                   gt[::-1] + 1.0]).astype(np.float32)
            arrays[f"0|{s}_bbox_corners"] = prop
            arrays[f"0|{s}_object_ids"] = np.concatenate(
                [ids, ids[::-1]]).astype(np.int32)
    h5, npz = str(root / f"eval_{mode}.hdf5"), str(root / f"eval_{mode}.npz")
    with h5py.File(h5, "w") as db, FeatureStoreWriter(npz) as st:
        for k, v in arrays.items():
            db[k] = v
            st[k] = v
    scanrefer = [e for e in databases["scanrefer"] if e["object_id"] != "99"]
    eval_entries = precli.one_per_scene(scanrefer)
    K = 8 if mode == "gt" else 16
    # the datasets' GloVe captions are 300-d
    kw = dict(_cfg(mode, 2, True), num_proposals=K, emb_size=300)
    jcls = (jpretrained.PretrainedGTDataset if mode == "gt"
            else jpretrained.PretrainedVoteNetDataset)
    tcls = (pretrained.PretrainedGTDataset if mode == "gt"
            else pretrained.PretrainedVoteNetDataset)
    glove = databases["glove"]
    jds = jcls(eval_entries, h5, split="val", glove=glove, K=K)
    ds = tcls(eval_entries, npz, split="val", glove=glove, K=K)
    jl = jdataset.Loader(jds, 2, shuffle=False, drop_last=False)
    tl = dataset.Loader(ds, 2, shuffle=False, drop_last=False)

    # a JAX model of K boxes (the mode's K is 128 or 256; the model reads
    # K from the batch), its weights in the port
    jmodel = JCapNetPretrained(JModelConfig(**kw), mode=mode,
                               num_vocabs=ds.num_vocabs)
    example = {k: jnp.asarray(v) for k, v in next(iter(jl)).items()}
    example["glove_emb_table"] = jnp.asarray(jds.emb_table)
    static = ("use_tf", "is_eval", "train")
    variables = jax.jit(jmodel.init, static_argnames=static)(
        jax.random.PRNGKey(2), example, use_tf=True, is_eval=False,
        train=False)
    apply = jax.jit(lambda b: jmodel.apply(variables, b, use_tf=False,
                                           is_eval=True, train=False))
    organized = _organized(scanrefer)
    want = jeval_pretrained.feed_pretrained_cap(apply, jds, jl, organized,
                                                mode=mode, min_iou=0.25)

    cfg = ModelConfig(**kw)
    model = CapNetPretrained(cfg, mode=mode, num_vocabs=ds.num_vocabs,
                             device="cpu")
    model.load_state_dict(state_dict_from_flax(variables["params"], {}),
                          strict=True)
    got = eval_pretrained.feed_pretrained_cap(
        make_eval_step(cfg, model, detection_loss=False), ds, tl, organized,
        mode=mode, min_iou=0.25, device="cpu")
    assert got == want and len(got) > 0
    if mode == "votenet":
        # the IoU gate drops some stored boxes of a kept object
        keys = {k.split("|")[1] for k in got if k.startswith(SCENES[2])}
        assert 0 < len(keys) <= 3
    jl.close()
    tl.close()
