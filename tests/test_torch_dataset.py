"""The port's ScanRefer dataset, Loader, vocabulary and data plane against
the JAX package's, and its checkpoint files.

Fixture scenes from tests/test_dataset.py go through both packages'
``ScannetReferenceDataset``: items, and the Loader's batches over two
epochs, must be equal key for key (``load_time`` is a wall-clock reading and
is left out), with and without augmentation, with colour, normals and
height, on the native data plane and its numpy fallback (each package's
against the other's), with ring buffers, and with host sharding.  Then the
checkpoint triad's crash-safety states.
"""

import os

import numpy as np
import pytest
import torch

from tests.test_dataset import make_fixture_glove, make_fixture_scene

import scan2cap_tpu.native as jnative
from scan2cap_tpu.data import dataset as jdataset
from scan2cap_tpu.data import vocab as jvocab

import scan2cap_torch.native as native
from scan2cap_torch.data import dataset, vocab
from scan2cap_torch.data.synthetic import to_device
from scan2cap_torch.train.checkpoints import (CheckpointIO, model_bundle,
                                              resume_bundle)

SCENES = ["scene0000_00", "scene0001_00", "scene0002_00"]
WORDS = ["this", "is", "a", "red", "chair", "next", "to", "the", "table"]


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    path = tmp_path_factory.mktemp("scannet")
    rng = np.random.RandomState(0)
    for s in SCENES:
        make_fixture_scene(str(path), s, rng, n_points=1800, n_obj=4)
    glove = make_fixture_glove(WORDS)
    rs = np.random.RandomState(1)
    scanrefer = [{"scene_id": s, "object_id": str(o),
                  "object_name": "chair", "ann_id": str(a),
                  "token": list(rs.choice(WORDS + ["unseen"], 5 + a)),
                  "description": ""}
                 for s in SCENES for o in range(3) for a in range(2)]
    rot = {s: {str(o): (np.eye(3) * (o + 1)).tolist() for o in (0, 2)}
           for s in SCENES[:2]}
    return str(path), scanrefer, glove, rot


def _pair(fixture, **kw):
    path, scanrefer, glove, rot = fixture
    args = dict(scannet_data_dir=path, glove_path="", glove=glove,
                num_points=1024, max_num_obj=16, use_height=True,
                use_color=True, use_normal=True, scan2cad_rotation=rot)
    args.update(kw)
    scenes = sorted({d["scene_id"] for d in scanrefer})
    return (jdataset.ScannetReferenceDataset(scanrefer, scenes, **args),
            dataset.ScannetReferenceDataset(scanrefer, scenes, **args))


def _equal(a, b, what):
    assert set(a) == set(b), what
    for k in a:
        if k == "load_time":
            continue
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, (what, k)
        np.testing.assert_array_equal(x, y, err_msg=f"{what}: {k}")


@pytest.fixture(params=["native", "numpy"])
def plane(request, monkeypatch):
    """Both packages' data planes on the native library, or both on their
    numpy fallbacks (SCAN2CAP_NATIVE=0)."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_tried", False)
    if request.param == "numpy":
        monkeypatch.setenv("SCAN2CAP_NATIVE", "0")
    else:
        monkeypatch.delenv("SCAN2CAP_NATIVE", raising=False)
    yield request.param
    native._lib, native._tried = None, False


@pytest.mark.parametrize("augment", [False, True])
def test_items_match_jax(fixture, plane, augment):
    jds, ds = _pair(fixture, augment=augment)
    if plane == "native":
        assert native.available() and jnative.available()
    else:
        assert not native.available()
    for i in range(len(ds)):
        _equal(jds.__getitem__(i, np.random.RandomState(i)),
               ds.__getitem__(i, np.random.RandomState(i)), f"item {i}")


def test_native_and_numpy_paths_agree(fixture, monkeypatch):
    """The port's native plane against the JAX package's numpy fallback:
    the row gather and the votes are exact copies and sums on both (the
    augmentation's rotation rounds differently in C++ and in numpy, in
    either package, so it is held package against package above)."""
    jds, ds = _pair(fixture, augment=False)
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_tried", True)          # fallback only
    assert native.available() and not jnative.available()
    for i in (0, 5, 11):
        _equal(jds.__getitem__(i, np.random.RandomState(i)),
               ds.__getitem__(i, np.random.RandomState(i)), f"item {i}")


@pytest.mark.parametrize("kw", [
    dict(augment=True),
    dict(augment=False, use_color=False, use_normal=False),
    dict(augment=True, use_height=False, use_normal=False)])
def test_loader_batches_match_jax_over_two_epochs(fixture, kw):
    jds, ds = _pair(fixture, **kw)
    jl = jdataset.Loader(jds, batch_size=4, shuffle=True, seed=3,
                         num_workers=2)
    tl = dataset.Loader(ds, batch_size=4, shuffle=True, seed=3,
                        num_workers=2)
    for epoch in range(2):
        got, want = list(tl), list(jl)
        assert len(got) == len(want) == len(ds) // 4
        for b, (x, y) in enumerate(zip(want, got)):
            _equal(x, y, f"epoch {epoch} batch {b}")
    jl.close()
    tl.close()


def test_ring_buffers_and_the_upload_copy(fixture):
    """With reuse_buffers the yielded batch is a ring slot that a worker
    overwrites later; the upload (to_device) copies it, so the uploaded
    tensors keep their values."""
    jds, ds = _pair(fixture, augment=True)
    jl = jdataset.Loader(jds, batch_size=2, shuffle=True, seed=5,
                         num_workers=2, reuse_buffers=True)
    tl = dataset.Loader(ds, batch_size=2, shuffle=True, seed=5,
                        num_workers=2, reuse_buffers=True)
    for _ in range(2):
        uploaded, slots = [], []
        for x, y in zip(jl, tl):
            _equal(x, y, "ring batch")
            uploaded.append(to_device(y, "cpu"))
            slots.append({k: np.array(v) for k, v in y.items()})
        for up, seen in zip(uploaded, slots):
            for k, v in seen.items():
                np.testing.assert_array_equal(up[k].numpy(), v, err_msg=k)
        # more batches than ring slots: every slot was overwritten after
        # its batch was uploaded
        assert len(slots) > tl.PREFETCH_BATCHES + 2
    jl.close()
    tl.close()


@pytest.mark.parametrize("shards", [2, 3])
def test_host_sharding_matches_jax(fixture, shards):
    jds, ds = _pair(fixture)
    seen = []
    for shard in range(shards):
        jl = jdataset.Loader(jds, 2, seed=7, num_workers=2, num_shards=shards,
                             shard_id=shard)
        tl = dataset.Loader(ds, 2, seed=7, num_workers=2, num_shards=shards,
                            shard_id=shard)
        assert len(jl) == len(tl)
        for x, y in zip(jl, tl):
            _equal(x, y, f"shard {shard}")
            seen += list(y["dataset_idx"])
        jl.close()
        tl.close()
    assert len(seen) == len(set(seen))            # no sample twice


def test_vocabulary_and_embedding_table_match_jax(fixture):
    _, scanrefer, glove, _ = fixture
    v, jv = vocab.build_vocabulary(scanrefer, glove), \
        jvocab.build_vocabulary(scanrefer, glove)
    assert v == jv and "unseen" not in v["word2idx"]
    np.testing.assert_array_equal(vocab.build_embedding_table(v, glove),
                                  jvocab.build_embedding_table(jv, glove))
    jds, ds = _pair(fixture)
    np.testing.assert_array_equal(ds.emb_table, jds.emb_table)
    for tokens in (["this", "is", "unseen"], WORDS * 5):
        for a, b in zip(vocab.encode_caption(tokens, v, glove),
                        jvocab.encode_caption(tokens, jv, glove)):
            np.testing.assert_array_equal(a, b)


def test_helpers_match_jax(fixture):
    from scan2cap_tpu.config import DC
    from scan2cap_tpu.utils import pc_utils as jpc
    from scan2cap_torch.config import param2obb_batch
    from scan2cap_torch.utils import pc_utils
    rs = np.random.RandomState(2)
    for f in ("rotx", "roty", "rotz"):
        np.testing.assert_array_equal(getattr(pc_utils, f)(0.3),
                                      getattr(jpc, f)(0.3))
    boxes = rs.randn(7, 6)
    np.testing.assert_array_equal(
        dataset.rotate_aligned_boxes_along_axis(boxes, pc_utils.roty(0.1), "y"),
        jdataset.rotate_aligned_boxes_along_axis(boxes, jpc.roty(0.1), "y"))
    args = (rs.randn(5, 3), np.zeros(5, int), np.zeros(5), rs.randint(0, 18, 5),
            rs.randn(5, 3))
    np.testing.assert_array_equal(param2obb_batch(*args),
                                  DC.param2obb_batch(*args))
    assert dataset.DC_NYU2CLS == jdataset.DC_NYU2CLS
    pc = rs.rand(50, 4)
    a = pc_utils.random_sampling(pc, 30, rs=np.random.RandomState(3))
    b = jpc.random_sampling(pc, 30, rs=np.random.RandomState(3))
    np.testing.assert_array_equal(a, b)


def test_data_plane_library_is_built_once_under_build(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.delenv("SCAN2CAP_NATIVE", raising=False)
    assert native.available()
    path = native.library_path()
    assert path.startswith(native.BUILD_DIR) and path.endswith(".so")
    mtime = os.path.getmtime(path)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    assert native.available()                      # loads, does not rebuild
    assert os.path.getmtime(path) == mtime


# --- checkpoints -----------------------------------------------------------
def _small_model():
    return torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Linear(4, 2))


def test_checkpoint_triad_round_trip(tmp_path):
    model = _small_model()
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    model(torch.randn(5, 3)).sum().backward()
    opt.step()
    io = CheckpointIO(str(tmp_path / "ckpt"))
    io.save("last", model_bundle(model))
    io.save("resume", resume_bundle(np.int64(3), model, opt, 7))
    assert not io.exists("best")
    got = io.restore_best_or_last()["model"]
    assert all(torch.equal(got[k], v) for k, v in model.state_dict().items())
    resume = io.restore("resume")
    assert resume["epoch"] == 3 and type(resume["epoch"]) is int
    assert resume["step"] == 7
    fresh = torch.optim.Adam(_small_model().parameters(), lr=1e-3)
    fresh.load_state_dict(resume["optimizer"])
    assert fresh.state_dict()["state"][0]["step"] == 1
    io.save("best", model_bundle(_small_model()))
    assert not torch.equal(io.restore_best_or_last()["model"]["0.weight"],
                           model.state_dict()["0.weight"])


def test_checkpoint_crash_states(tmp_path):
    root = tmp_path / "ckpt"
    io = CheckpointIO(str(root))
    a, b = _small_model(), _small_model()
    io.save("last", model_bundle(a))
    # a kill after the write of last.pt.new, before the swap: promoted
    torch.save(model_bundle(b), root / "last.pt.new")
    # a kill during the write of resume.pt.new: removed, nothing promoted
    (root / "resume.pt.new").write_bytes(b"PK\x03\x04 cut short")
    # a set-aside best.pt.old with no best.pt: promoted
    torch.save(model_bundle(a), root / "best.pt.old")
    io = CheckpointIO(str(root))
    assert sorted(p.name for p in root.iterdir()) == ["best.pt", "last.pt"]
    got = io.restore("last")["model"]
    assert all(torch.equal(got[k], v) for k, v in b.state_dict().items())
    # a best.pt.old beside a best.pt is stale: removed
    torch.save(model_bundle(b), root / "best.pt.old")
    CheckpointIO(str(root))
    assert not (root / "best.pt.old").exists()
    got = io.restore("best")["model"]
    assert all(torch.equal(got[k], v) for k, v in a.state_dict().items())
