"""The port's 2D baselines (``scan2cap_torch/twod``) against the JAX
package's (``scan2cap_tpu/twod``) on the CPU; mirrors ``tests/test_twod.py``.

* ``ShowAndTell2D`` and ``ShowAttendAndTell2D`` (with and without the
  global feature) on the JAX model's initial weights, carried by
  ``convert.state_dict_from_flax`` and loaded with ``strict=True``:
  teacher-forced logits and attention within 1e-4 of the largest value,
  greedy tokens exact; the eval decode of ``ShowAttendAndTell2D`` feeds the
  raw ``t_feat``; the port's models learn on a fixed batch.
* ``Retrieval2D`` equal to the JAX one (a copy, argmax ties included).
* The feature store with groups and attributes: nested keys, an optional
  ``c_feats``, ``extractor_backend`` read back by ``np.load`` alone and
  through HDF5 both ways.
* ``build_database`` writes the store the JAX one writes as HDF5 (the
  random-projection extractor on the same renders): after
  ``convert_feature_db`` the arrays are bitwise equal and carry the same
  tag; ``TwoDDataset`` items from either equal the JAX dataset's.
"""

import numpy as np
import h5py
import jax
import jax.numpy as jnp
import pytest
import torch

from scan2cap_tpu.data.synthetic import make_vocab
from scan2cap_tpu.losses.pretrained import compute_cap_loss_gt as jloss
from scan2cap_tpu.twod import models as jmodels

from scan2cap_torch.convert import state_dict_from_flax
from scan2cap_torch.data.feature_store import (FeatureStoreWriter,
                                               open_feature_store)
from scan2cap_torch.losses.pretrained import compute_cap_loss_gt
from scan2cap_torch.scripts.convert_feature_db import convert
from scan2cap_torch.twod import models
from scan2cap_torch.twod.conf import get_config

from tests.test_dataset import make_fixture_glove

TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one thread: idle threads spinning on cores that other test
    workers share make the file many times dearer."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _lang(rng, table, B, T=32):
    ids = np.zeros((B, T), np.int32)
    feat = np.zeros((B, T, table.shape[1]), np.float32)
    lens = np.zeros((B,), np.int32)
    for b in range(B):
        k = rng.randint(3, 8)
        seq = [2] + list(rng.randint(4, len(table), k)) + [3]
        ids[b, :len(seq)] = seq
        feat[b, :len(seq)] = table[seq]
        lens[b] = len(seq)
    return feat, ids, lens


def _batch(rng, B=3, P=5, gw=64, tw=68, V=32):
    vocab = make_vocab(num_vocabs=V)
    feat, ids, lens = _lang(rng, vocab["emb_table"], B)
    return {
        "g_feat": rng.randn(B, gw).astype(np.float32),
        "t_feat": rng.randn(B, tw).astype(np.float32),
        "c_feats": rng.randn(B, P, tw).astype(np.float32),
        "lang_feat": feat, "lang_ids": ids, "lang_len": lens,
        "glove_emb_table": vocab["emb_table"],
    }


def _pair(jmodel, port_cls, port_kw, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jax.jit(jmodel.init, static_argnames=("is_eval",))(
        jax.random.PRNGKey(0), jb, is_eval=False)
    model = port_cls(**port_kw)
    model.load_state_dict(state_dict_from_flax(variables["params"]),
                          strict=True)
    return variables, model, jb, {k: torch.from_numpy(np.asarray(v))
                                  for k, v in batch.items()}


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * np.abs(want).max(), err_msg=what)


def _both_ways(jmodel, variables, model, jb, tb, keys):
    apply = jax.jit(jmodel.apply, static_argnames=("is_eval",))
    with torch.no_grad():
        for is_eval in (False, True):
            want = apply(variables, jb, is_eval=is_eval)
            got = model(tb, is_eval=is_eval)
            for k in keys:
                if is_eval and k == "lang_cap":
                    np.testing.assert_array_equal(
                        got[k].numpy(), np.asarray(want[k]),
                        err_msg="greedy tokens")
                else:
                    _close(got[k].numpy(), want[k], f"{k} eval={is_eval}")
    return got


def test_show_and_tell_matches_jax(rng):
    batch = _batch(rng)
    jm = jmodels.ShowAndTell2D(num_vocabs=32, feat_size=64 + 68,
                               hidden_size=96, max_desc_len=30)
    variables, model, jb, tb = _pair(
        jm, models.ShowAndTell2D,
        dict(num_vocabs=32, feat_size=64 + 68, hidden_size=96,
             max_desc_len=30), batch)
    got = _both_ways(jm, variables, model, jb, tb, ("lang_cap", "inp_feat"))
    assert got["lang_cap"].shape == (3, 29)
    with torch.no_grad():
        assert model(tb)["lang_cap"].shape == (3, 31, 32)
    # the loss of the teacher-forced logits, against JAX's
    want = float(jloss(jax.jit(jm.apply)(variables, jb))[0])
    with torch.no_grad():
        loss = float(compute_cap_loss_gt(model(tb))[0])
    np.testing.assert_allclose(loss, want, rtol=1e-5)


def test_show_and_tell_learns(rng):
    batch = _batch(rng, B=2)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    torch.manual_seed(0)
    model = models.ShowAndTell2D(num_vocabs=32, feat_size=64 + 68,
                                 hidden_size=96, max_desc_len=30)
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    losses = []
    for _ in range(30):
        loss = compute_cap_loss_gt(model(tb))[0]
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    assert losses[-1] < 0.5 * losses[0]


@pytest.mark.parametrize("add_global", [True, False])
def test_show_attend_and_tell_matches_jax(rng, add_global):
    tw = 68
    batch = _batch(rng, tw=tw)
    feat = 64 + tw
    jm = jmodels.ShowAttendAndTell2D(num_vocabs=32, feat_size=feat,
                                     context_size=tw, hidden_size=96,
                                     add_global=add_global)
    variables, model, jb, tb = _pair(
        jm, models.ShowAttendAndTell2D,
        dict(num_vocabs=32, feat_size=feat, context_size=tw, hidden_size=96,
             add_global=add_global), batch)
    got = _both_ways(jm, variables, model, jb, tb,
                     ("lang_cap", "topdown_attn", "inp_feat"))
    assert got["lang_cap"].shape == (3, 29)
    assert got["topdown_attn"].shape == (3, 5, 29)


def test_tdbu_eval_feeds_the_raw_target_feature(rng):
    """With the global feature on, eval decodes from the raw ``t_feat``:
    changing ``g_feat`` moves the teacher-forced logits but not the
    greedy tokens."""
    batch = _batch(rng, tw=68)
    model = models.ShowAttendAndTell2D(num_vocabs=32, feat_size=64 + 68,
                                       context_size=68, hidden_size=96)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    tb2 = dict(tb, g_feat=tb["g_feat"] + 5.0)
    with torch.no_grad():
        assert torch.equal(model(tb, is_eval=True)["lang_cap"],
                           model(tb2, is_eval=True)["lang_cap"])
        assert not torch.equal(model(tb)["lang_cap"], model(tb2)["lang_cap"])


def test_retrieval_matches_jax(rng):
    feats = {f"s{i}": rng.randn(68).astype(np.float32) for i in range(10)}
    feats["s9"] = feats["s2"].copy()                 # a tie: the first wins
    lang = {f"s{i}": np.full(5, i) for i in range(10)}
    q = {"t_feat": np.stack([feats["s3"], feats["s7"], feats["s2"],
                             rng.randn(68).astype(np.float32)])}
    got = models.Retrieval2D(feats, lang, ignore_last=4)(q)
    want = jmodels.Retrieval2D(feats, lang, ignore_last=4)(q)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0], lang["s3"])
    np.testing.assert_array_equal(got[2], lang["s2"])


def test_store_groups_and_attributes(tmp_path, rng):
    arrays = {"scene0000_00-0_0/g_feat": rng.randn(16).astype(np.float32),
              "scene0000_00-0_0/t_feat": rng.randn(20).astype(np.float32),
              "scene0000_00-0_0/c_feats": np.zeros((0, 20), np.float32),
              "scene0000_00-1_0/g_feat": rng.randn(16).astype(np.float32),
              "scene0000_00-1_0/t_feat": rng.randn(20).astype(np.float32)}
    npz = str(tmp_path / "f.npz")
    with FeatureStoreWriter(npz) as w:
        w.set_attr("extractor_backend", "resnet:pth")
        w.set_attr("count", 5)
        for k, v in arrays.items():
            w[k] = v
    with open_feature_store(npz) as db:
        assert sorted(db.keys()) == sorted(arrays)
        assert db.attrs == {"extractor_backend": "resnet:pth", "count": 5}
        assert "scene0000_00-1_0/c_feats" not in db
        assert "scene0000_00-0_0/c_feats" in db
        for k, v in arrays.items():
            assert db[k].dtype == v.dtype and np.array_equal(db[k], v)
    # numpy alone reads the arrays and the attribute
    plain = np.load(npz)
    assert str(plain["__attrs__/extractor_backend"][()]) == "resnet:pth"
    assert np.array_equal(plain["scene0000_00-0_0/t_feat"],
                          arrays["scene0000_00-0_0/t_feat"])
    # to HDF5 (groups and file attributes) and back
    h5 = str(tmp_path / "f.hdf5")
    assert convert(npz, h5) == len(arrays)
    with h5py.File(h5, "r") as f:
        assert f.attrs["extractor_backend"] == "resnet:pth"
        assert isinstance(f["scene0000_00-0_0"], h5py.Group)
        assert f["scene0000_00-0_0/c_feats"].shape == (0, 20)
    back = str(tmp_path / "g.npz")
    convert(h5, back)
    with open_feature_store(back) as db:
        assert db.attrs == {"extractor_backend": "resnet:pth", "count": 5}
        for k, v in arrays.items():
            assert np.array_equal(db[k], v)


def _entries():
    return [{"scene_id": "scene0000_00", "object_id": str(o),
             "ann_id": "0", "object_name": "chair",
             "token": ["a", "red", "chair"][:2 + o % 2]} for o in range(4)]


def _renders(seed=3):
    rs = np.random.RandomState(seed)
    images = {o: rs.rand(240, 320, 3).astype(np.float32) for o in range(4)}
    boxes = {0: [{"box": (10, 10, 100, 100), "is_target": True},
                 {"box": (50, 50, 150, 150), "is_target": False}],
             1: [{"box": (-30, 20, -5, 90), "is_target": True},  # outside
                 {"box": (300, 200, 400, 300), "is_target": False},
                 {"box": (0, 0, 320, 240), "is_target": False}],
             2: [{"box": (40, 60, 41, 61), "is_target": False}],  # no target
             3: []}                                            # no box
    return images, boxes


@pytest.fixture(scope="module")
def databases(tmp_path_factory):
    from scan2cap_tpu.twod.preprocessing import (
        build_database as jbuild, make_resnet_extractor as jextractor)
    from scan2cap_torch.twod.preprocessing import (build_database,
                                                   make_resnet_extractor)

    tmp = tmp_path_factory.mktemp("twod_db")
    images, boxes = _renders()

    def load_image(e):
        return images[int(e["object_id"])]

    def load_boxes(e):
        return boxes[int(e["object_id"])]

    jpath = str(tmp / "jax.hdf5")
    jbuild(jpath, _entries() + _entries()[:1], load_image, load_boxes,
           extractor=jextractor())
    path = str(tmp / "port.npz")
    extract = make_resnet_extractor(device="cpu")
    assert extract.backend == "random-projection-fallback"
    build_database(path, _entries() + _entries()[:1], load_image, load_boxes,
                   extractor=extract)
    converted = str(tmp / "converted.npz")
    convert(jpath, converted)
    return jpath, path, converted


def test_build_database_matches_jax(databases):
    jpath, path, converted = databases
    with h5py.File(jpath, "r") as j, open_feature_store(path) as p, \
            open_feature_store(converted) as c:
        assert p.attrs["extractor_backend"] == j.attrs["extractor_backend"]
        assert c.attrs["extractor_backend"] == j.attrs["extractor_backend"]
        want = {}
        j.visititems(lambda n, o: want.__setitem__(n, np.asarray(o))
                     if isinstance(o, h5py.Dataset) else None)
        assert len(want) == 12
        for db in (p, c):
            assert sorted(db.keys()) == sorted(want)
            for k, v in want.items():
                assert db[k].dtype == v.dtype, k
        for k, v in want.items():
            # the converted JAX database and the port's own extraction
            # (the same host projection) bit for bit
            assert c[k].tobytes() == v.tobytes(), k
            assert p[k].tobytes() == v.tobytes(), k
    # the crop of a box outside the render is the whole frame, and a
    # sample without a target box stores zeros
    with open_feature_store(converted) as c:
        assert c["scene0000_00-1_0/c_feats"].shape == (2, 2052)
        assert not c["scene0000_00-2_0/t_feat"].any()
        assert c["scene0000_00-3_0/c_feats"].shape == (0, 2052)


def test_dataset_items_match_jax(databases, capsys):
    from scan2cap_tpu.twod.dataset import TwoDDataset as JDataset
    from scan2cap_torch.twod.dataset import TwoDDataset, sample_id_of

    jpath, path, converted = databases
    glove = make_fixture_glove(["a", "red", "chair"])
    cfg = get_config("nonretrieval", "annotated", "oracle", "tdbu")
    jds = JDataset(_entries(), cfg, glove, db_path=jpath)
    ds = TwoDDataset(_entries(), cfg, glove, db_path=converted)
    assert ds.vocabulary == jds.vocabulary
    np.testing.assert_array_equal(ds.emb_table, jds.emb_table)
    for i in range(len(ds)):
        want, got = jds[i], ds[i]
        assert set(got) == set(want)
        for k in want:
            if k == "load_time":
                continue
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    out = capsys.readouterr()
    assert out.out.count(
        "extractor=random-projection-fallback") == 2      # once per dataset
    assert out.err.count("WARNING: features are the non-semantic") == 2
    assert sample_id_of(_entries()[1]) == "scene0000_00-1_0"
    assert sample_id_of(_entries()[1], "kk") == "scene0000_00-1"
    d = ds[0]
    assert d["c_feats"].shape == (cfg.num_proposals, 2052)
    assert d["c_mask"].sum() == 1 and d["lang_ids"][0] == 2


def test_config_names_the_store(monkeypatch, tmp_path):
    from scan2cap_tpu.twod.conf import get_config as jget_config
    monkeypatch.setenv("SCAN2CAP_2D_DATA", str(tmp_path))
    cfg = get_config("nonretrieval", "bev", "votenet", "tdbu")
    want = jget_config("nonretrieval", "bev", "votenet", "tdbu")
    assert cfg.db_path == str(tmp_path / "bev_votenet_features.npz")
    assert want.db_path == str(tmp_path / "bev_votenet_features.hdf5")
    assert cfg.add_context and cfg.feat_input == want.feat_input
    for f in ("max_desc_len", "emb_size", "hidden_size", "global_feat_size",
              "target_feat_size", "num_proposals"):
        assert getattr(cfg, f) == getattr(want, f), f
    with pytest.raises(AssertionError):
        get_config("nonretrieval", "top", "oracle")


def test_tdbu_step_matches_torch_reference(rng):
    """One decode step of the port's model against torch's own
    ``nn.GRUCell`` build of the reference equations (tdbu.py:55-103)."""
    B, P, V, E, C, H = 3, 5, 20, 16, 24, 32
    model = models.ShowAttendAndTell2D(num_vocabs=V, emb_size=E,
                                       feat_size=48, context_size=C,
                                       hidden_size=H, max_desc_len=4,
                                       add_global=False)
    d = {"t_feat": torch.from_numpy(rng.randn(B, C).astype(np.float32)),
         "c_feats": torch.from_numpy(rng.randn(B, P, C).astype(np.float32)),
         "lang_feat": torch.from_numpy(rng.randn(B, 5, E).astype(np.float32))}
    with torch.no_grad():
        out = model(d)

        def gru(cell, in_size):
            g = torch.nn.GRUCell(in_size, H)
            g.weight_ih.copy_(cell.ih.weight)
            g.weight_hh.copy_(cell.hh.weight)
            g.bias_ih.copy_(cell.ih.bias)
            g.bias_hh.copy_(cell.hh.bias)
            return g

        m = model
        h2 = torch.zeros(B, H)
        x = torch.tanh(m.map_topdown_3(d["lang_feat"][:, 0])
                       + m.map_topdown_1(h2) + m.map_topdown_2(d["t_feat"]))
        x = torch.relu(m.map_topdown(x))
        h1 = gru(m.recurrent_cell_1, 128)(x, torch.zeros(B, H))
        masks = torch.softmax(m.attend(torch.tanh(
            m.map_feat(d["c_feats"]) + m.map_hidd(h1).unsqueeze(1))), dim=1)
        lang = torch.tanh(m.map_lang_1((d["c_feats"] * masks).sum(1))
                          + m.map_lang_2(h1))
        h2 = gru(m.recurrent_cell_2, 128)(torch.relu(m.map_lang(lang)), h2)
        want = m.classifier(h2)
    np.testing.assert_allclose(out["lang_cap"][:, 0], want, atol=2e-5)
    np.testing.assert_allclose(out["topdown_attn"][:, :, 0], masks[..., 0],
                               atol=2e-6)
