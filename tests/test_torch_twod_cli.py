"""The 2D baselines' entry point (``python -m scan2cap_torch.twod.main``)
in process with ``--device cpu``; mirrors ``tests/test_cli_twod.py``.

* ``--prep`` on JPEG renders and a box JSON writes the store the JAX
  package's ``build_database`` writes as HDF5 from the same files (the
  random-projection extractor, offline): every array bitwise, the same
  backend tag; with ``--resnet_pth`` (a tiny torchvision-layout ResNet)
  the features within 1e-4 relative of the JAX extractor's, tagged
  ``resnet:pth``.
* ``--train`` then ``--eval`` for ``snt`` and ``tdbu`` at the published
  widths (2048-d global, 2052-d box features, hidden 512, GloVe 300): the
  loss finite, the checkpoint under ``outputs/2d_{model}_{tag}/ckpt``,
  the four scores printed; the trained weights carried into the JAX model
  (``convert.flax_from_state_dict``) give the same greedy captions on the
  JAX dataset's val batch.
* ``--model retr`` builds the bank of the 4 train samples.
"""

import json
import pickle

import h5py
import numpy as np
import pytest
import torch

from tests.test_dataset import make_fixture_glove

from scan2cap_torch.data.feature_store import open_feature_store
from scan2cap_torch.twod import main as twod_main
from scan2cap_torch.twod.conf import GLOBAL_FEATURE_SIZE, TARGET_FEATURE_SIZE

WORDS = ["this", "is", "a", "red", "chair", "table"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one thread: idle threads spinning on cores that other test
    workers share make the file many times dearer."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _entries(scene_ids, tokens):
    out = []
    for s in scene_ids:
        for obj in range(2):
            out.append({"scene_id": s, "object_id": str(obj),
                        "object_name": "chair", "ann_id": "0",
                        "token": tokens[obj],
                        "description": " ".join(tokens[obj])})
    return out


@pytest.fixture
def twod_data(tmp_path, monkeypatch):
    rng = np.random.RandomState(0)
    data, d2 = tmp_path / "data", tmp_path / "2d"
    data.mkdir()
    d2.mkdir()
    with open(data / "glove.p", "wb") as f:
        pickle.dump(make_fixture_glove(WORDS), f)
    tokens = (["this", "is", "a", "red", "chair"], ["a", "table"])
    train = _entries(["scene0000_00", "scene0001_00"], tokens)
    val = _entries(["scene0002_00"], tokens)
    with open(data / "ScanRefer_filtered_train.json", "w") as f:
        json.dump(train, f)
    with open(data / "ScanRefer_filtered_val.json", "w") as f:
        json.dump(val, f)
    # a JAX-layout HDF5 (one group per sample), converted to the store
    h5 = tmp_path / "annotated_oracle_features.hdf5"
    with h5py.File(h5, "w") as db:
        db.attrs["extractor_backend"] = "custom"
        for e in train + val:
            sid = "{}-{}_{}".format(e["scene_id"], e["object_id"],
                                    e["ann_id"])
            g = db.create_group(sid)
            g["g_feat"] = rng.randn(GLOBAL_FEATURE_SIZE).astype(np.float32)
            g["t_feat"] = rng.randn(TARGET_FEATURE_SIZE).astype(np.float32)
            g["c_feats"] = rng.randn(3, TARGET_FEATURE_SIZE).astype(
                np.float32)
    from scan2cap_torch.scripts.convert_feature_db import convert
    convert(str(h5), str(d2 / "annotated_oracle_features.npz"))
    monkeypatch.setenv("SCAN2CAP_DATA", str(data))
    monkeypatch.setenv("SCAN2CAP_OUTPUT", str(tmp_path / "outputs"))
    monkeypatch.setenv("SCAN2CAP_2D_DATA", str(d2))
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    return tmp_path, train, val, h5


def _renders(root, entries, rng):
    from PIL import Image
    images = root / "renders"
    images.mkdir()
    boxes = {}
    for e in entries:
        sid = "{}-{}_{}".format(e["scene_id"], e["object_id"], e["ann_id"])
        img = (rng.rand(240, 320, 3) * 255).astype(np.uint8)
        Image.fromarray(img).save(images / f"{sid}.jpg")
        boxes[sid] = [{"box": [10, 10, 60, 60], "is_target": True},
                      {"box": [100, 50, 180, 120], "is_target": False}]
    with open(root / "boxes.json", "w") as f:
        json.dump(boxes, f)
    return images, boxes


def _jax_database(path, entries, images, boxes, extractor):
    from PIL import Image
    from scan2cap_tpu.twod.dataset import sample_id_of
    from scan2cap_tpu.twod.preprocessing import build_database

    def load_image(e):
        return np.asarray(Image.open(images / (sample_id_of(e) + ".jpg"))
                          .convert("RGB"), np.float32) / 255.0

    build_database(str(path), entries, load_image,
                   lambda e: boxes.get(sample_id_of(e), []),
                   extractor=extractor)


def _h5_arrays(path):
    out = {}
    with h5py.File(path, "r") as db:
        db.visititems(lambda n, o: out.__setitem__(n, np.asarray(o))
                      if isinstance(o, h5py.Dataset) else None)
        return out, db.attrs["extractor_backend"]


def test_prep_builds_the_store(twod_data, monkeypatch):
    from scan2cap_tpu.twod.preprocessing import make_resnet_extractor

    root, train, val, _ = twod_data
    images, boxes = _renders(root, train + val, np.random.RandomState(1))
    out = root / "2d_prep"
    out.mkdir()
    monkeypatch.setenv("SCAN2CAP_2D_DATA", str(out))
    path = twod_main.main(["--prep", "--images_root", str(images),
                           "--boxes", str(root / "boxes.json"),
                           "--device", "cpu"])
    assert path == str(out / "annotated_oracle_features.npz")
    want_path = root / "jax_prep.hdf5"
    _jax_database(want_path, train + val, images, boxes,
                  make_resnet_extractor())
    want, backend = _h5_arrays(want_path)
    assert len(want) == 18                        # 6 samples x 3 keys
    with open_feature_store(path) as db:
        assert db.attrs["extractor_backend"] == backend == \
            "random-projection-fallback"
        assert sorted(db.keys()) == sorted(want)
        for k, v in want.items():
            assert db[k].dtype == v.dtype and db[k].tobytes() == v.tobytes()
        assert db["scene0000_00-0_0/c_feats"].shape == (1, TARGET_FEATURE_SIZE)


def test_prep_with_a_resnet_pth(twod_data, monkeypatch):
    from tests.test_convert_resnet import TinyResNet, _randomized
    from scan2cap_tpu.twod.resnet import make_pth_extractor as jextractor

    root, train, val, _ = twod_data
    images, boxes = _renders(root, train, np.random.RandomState(2))
    pth = root / "resnet_tiny.pth"
    torch.save(_randomized(TinyResNet(width=64)).state_dict(), pth)
    out = root / "2d_pth"
    out.mkdir()
    monkeypatch.setenv("SCAN2CAP_2D_DATA", str(out))
    # the renders of the val split are missing: only the train split's
    with open(root / "data" / "ScanRefer_filtered_val.json", "w") as f:
        json.dump([], f)
    path = twod_main.main(["--prep", "--images_root", str(images),
                           "--boxes", str(root / "boxes.json"),
                           "--resnet_pth", str(pth), "--device", "cpu"])
    want_path = root / "jax_pth.hdf5"
    _jax_database(want_path, train, images, boxes, jextractor(str(pth)))
    want, backend = _h5_arrays(want_path)
    with open_feature_store(path) as db:
        assert db.attrs["extractor_backend"] == backend == "resnet:pth"
        assert sorted(db.keys()) == sorted(want)
        for k, v in want.items():
            assert db[k].shape == v.shape, k
            np.testing.assert_allclose(db[k], v, rtol=1e-4,
                                       atol=1e-4 * np.abs(v).max(),
                                       err_msg=k)


def _jax_candidates(root, model_name, train, val, state_dict):
    """The JAX model on the port's trained weights over the JAX dataset's
    val batch: its greedy captions."""
    import jax.numpy as jnp
    from scan2cap_tpu.data.vocab import load_glove
    from scan2cap_tpu.eval.eval_helper import decode_caption
    from scan2cap_tpu.twod.conf import get_config
    from scan2cap_tpu.twod.dataset import TwoDDataset
    from scan2cap_tpu.twod.main import build_model

    from scan2cap_torch.convert import flax_from_state_dict

    cfg = get_config("nonretrieval", "annotated", "oracle", model_name)
    glove = load_glove(str(root / "data" / "glove.p"))
    db = str(root / "annotated_oracle_features.hdf5")
    train_ds = TwoDDataset(train, cfg, glove, db_path=db)
    val_ds = TwoDDataset(val, cfg, glove, vocab=train_ds.vocabulary,
                         db_path=db)
    items = [val_ds[i] for i in range(len(val_ds))]
    batch = {k: jnp.asarray(np.stack([d[k] for d in items]))
             for k in items[0]}
    batch["glove_emb_table"] = jnp.asarray(train_ds.emb_table)
    params, _ = flax_from_state_dict(state_dict)
    model = build_model(cfg, train_ds.num_vocabs)
    caps = np.asarray(model.apply({"params": params}, batch, is_eval=True)
                      ["lang_cap"])
    out = {}
    for e, c in zip(val, caps):
        key = "{}|{}|{}".format(e["scene_id"], e["object_id"],
                                e["object_name"])
        out[key] = [decode_caption(c, val_ds.vocabulary["idx2word"])]
    return out


@pytest.mark.parametrize("model,epochs", [("snt", 2), ("tdbu", 1)])
def test_train_then_eval(twod_data, capsys, model, epochs):
    root, train, val, _ = twod_data
    out_dir = twod_main.main(["--train", "--epoch", str(epochs),
                              "--batch_size", "2", "--model", model,
                              "--tag", "t", "--device", "cpu"])
    assert out_dir == str(root / "outputs" / f"2d_{model}_t")
    ckpt = root / "outputs" / f"2d_{model}_t" / "ckpt" / "best.pt"
    assert ckpt.exists()
    text = capsys.readouterr().out
    assert "[e0 it1] loss" in text and "saved to" in text
    loss = float(text.split("[e0 it1] loss ")[1].split()[0])
    assert np.isfinite(loss)
    res = twod_main.main(["--eval", "--batch_size", "2", "--model", model,
                          "--tag", "t", "--device", "cpu"])
    text = capsys.readouterr().out
    for name in ("[BLEU-4]", "[CIDEr]", "[ROUGE]", "[METEOR]"):
        assert name in text, text[-1000:]
    assert "extractor=custom" in text
    assert all(np.isfinite(res[k]) for k in ("bleu-4", "cider", "rouge",
                                             "meteor"))
    sd = torch.load(ckpt, weights_only=True)["model"]
    assert res["candidates"] == _jax_candidates(root, model, train, val, sd)


def test_retrieval_bank(twod_data, capsys):
    bank = twod_main.main(["--train", "--model", "retr", "--device", "cpu"])
    assert "retrieval bank built: 4 samples" in capsys.readouterr().out
    assert len(bank.keys) == 4 and bank.bank.shape == (4, 2048)


def test_needs_cuda_unless_asked(twod_data):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        twod_main.main(["--train", "--model", "retr"])
