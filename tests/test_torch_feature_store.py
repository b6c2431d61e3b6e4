"""The port's feature store (``scan2cap_torch/data/feature_store.py``) and
its converter, on the CPU.

The store keeps a feature database (the JAX package's HDF5 keys, dtypes and
shapes) in an uncompressed ``.npz``.  Held here: every dtype the databases
hold round-trips bitwise, empty arrays and keys with ``|`` included, plain
``np.load`` reads it, reads from the Loader's four threads through one
handle equal serial reads, HDF5 -> store -> HDF5 through the converter is
bitwise both ways, an HDF5 path without ``h5py`` names the converter, and
the scene datasets' multiview read from the store equals the JAX package's
from HDF5, item for item and batch for batch.
"""

import builtins
import sys
import threading

import h5py
import numpy as np
import pytest

from tests.test_dataset import make_fixture_glove, make_fixture_scene

from scan2cap_tpu.data import dataset as jdataset
from scan2cap_tpu.data import dataset_maskvotenet as jmask_dataset

from scan2cap_torch import config
from scan2cap_torch.data import dataset, dataset_maskvotenet
from scan2cap_torch.data.feature_store import (FeatureStoreWriter,
                                               LazyStore, open_feature_store)
from scan2cap_torch.scripts import convert_feature_db

SCENE = "scene0000_00"


def _database(rs):
    """The keys and arrays of a GT and a VoteNet database, as the JAX
    extractors write them (ids int64 and int32, features and corners
    float32), a multiview array, an empty proposal list and a float64."""
    return {
        f"0|{SCENE}_gt_ids": np.asarray([3, 1, 4]),
        f"0|{SCENE}_features": rs.randn(3, 128).astype(np.float32),
        f"0|{SCENE}_bbox_corners": rs.randn(3, 8, 3).astype(np.float32),
        f"1|{SCENE}_gt_corners": rs.randn(3, 8, 3).astype(np.float32),
        f"0|{SCENE}_object_ids": np.asarray([2, 0], np.int32),
        "0|scene0001_00_features": np.zeros((0, 128), np.float32),
        "0|scene0001_00_object_ids": np.zeros((0,), np.int32),
        SCENE: rs.randn(1000, 128).astype(np.float32),
        "scalar": np.float64(2.5),
        "float64": rs.randn(4, 2),
    }


def _write(path, arrays):
    with FeatureStoreWriter(str(path)) as w:
        for k, v in arrays.items():
            w[k] = v


def _same(got, want, what):
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert got.tobytes() == want.tobytes(), what


@pytest.fixture
def store(tmp_path):
    arrays = _database(np.random.RandomState(0))
    path = tmp_path / "db.npz"
    _write(path, arrays)
    return path, arrays


@pytest.mark.parametrize("dtype", ["float32", "int32", "int64", "float64",
                                   "uint8", "bool"])
@pytest.mark.parametrize("shape", [(5,), (0,), (3, 128), (0, 8, 3),
                                   (2, 8, 3), ()])
def test_round_trip_is_bitwise(tmp_path, dtype, shape):
    rs = np.random.RandomState(1)
    arr = np.asarray(rs.randn(*shape) * 100).astype(dtype)
    key = f"7|{SCENE}_features"
    _write(tmp_path / "x.npz", {key: arr})
    with open_feature_store(str(tmp_path / "x.npz")) as db:
        assert list(db.keys()) == [key] and key in db and len(db) == 1
        _same(db[key], arr, key)
        assert db.shape(key) == shape and db.dtype(key) == arr.dtype


def test_all_keys_round_trip_and_plain_np_load_reads_them(store):
    path, arrays = store
    with open_feature_store(str(path)) as db:
        assert set(db.keys()) == set(arrays)
        assert "missing" not in db
        for k, v in arrays.items():
            _same(db[k], np.asarray(v), k)
        with pytest.raises(KeyError):
            db["missing"]
    with np.load(path) as npz:
        assert set(npz.files) == set(arrays)
        for k, v in arrays.items():
            _same(npz[k], np.asarray(v), k)


def test_fortran_order_arrays_read_back_equal(tmp_path):
    arr = np.asfortranarray(np.arange(24, dtype=np.float32).reshape(4, 6))
    _write(tmp_path / "f.npz", {"f": arr})
    with open_feature_store(str(tmp_path / "f.npz")) as db:
        np.testing.assert_array_equal(db["f"], arr)
        with pytest.raises(ValueError, match="Fortran order"):
            db.read_into("f", np.empty((4, 6), np.float32))


def test_read_into_fills_the_callers_buffer(store):
    path, arrays = store
    with open_feature_store(str(path)) as db:
        buf = np.full((2000, 128), np.nan, np.float32)
        out = db.read_into(SCENE, buf[:1000])
        assert out.base is buf or out.base is buf.base
        _same(buf[:1000], arrays[SCENE], SCENE)
        assert np.isnan(buf[1000:]).all()
        with pytest.raises(ValueError, match="got a buffer"):
            db.read_into(SCENE, np.empty((999, 128), np.float32))
        with pytest.raises(ValueError, match="got a buffer"):
            db.read_into(SCENE, np.empty((1000, 128), np.float64))


def test_a_key_is_written_once(tmp_path):
    with FeatureStoreWriter(str(tmp_path / "d.npz")) as w:
        w["a|b"] = np.zeros(3)
        with pytest.raises(KeyError, match="already"):
            w["a|b"] = np.ones(3)
        with pytest.raises(TypeError, match="object arrays"):
            w["o"] = np.array([{}], dtype=object)


def test_four_threads_read_what_one_reads(store):
    path, arrays = store
    keys = sorted(arrays) * 40
    with open_feature_store(str(path)) as serial:
        want = {k: serial[k].tobytes() for k in arrays}
    lazy = LazyStore(str(path))
    errors, handles = [], set()
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def reader(offset):
            try:
                for k in keys[offset::4]:
                    db = lazy.get()
                    handles.add(id(db))
                    if db[k].tobytes() != want[k]:
                        errors.append(k)
            except Exception as e:     # pragma: no cover - reported below
                errors.append(repr(e))

        threads = [threading.Thread(target=reader, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    assert not errors, errors[:5]
    assert len(handles) == 1                # one handle, opened once


@pytest.mark.parametrize("suffix", [".hdf5", ".h5"])
def test_hdf5_to_store_to_hdf5_is_bitwise(tmp_path, suffix):
    arrays = _database(np.random.RandomState(2))
    src = tmp_path / f"jax{suffix}"
    with h5py.File(src, "w") as db:          # as the JAX extractors write
        for k, v in arrays.items():
            db[k] = v
    store = tmp_path / "port.npz"
    assert convert_feature_db.main([str(src), str(store)]) == len(arrays)
    with open_feature_store(str(store)) as db:
        assert set(db.keys()) == set(arrays)
        for k, v in arrays.items():
            _same(db[k], np.asarray(v), k)
    back = tmp_path / f"back{suffix}"
    convert_feature_db.convert(str(store), str(back))
    with h5py.File(src, "r") as a, h5py.File(back, "r") as b:
        assert set(a.keys()) == set(b.keys())
        for k in a.keys():
            _same(np.asarray(b[k]), np.asarray(a[k]), k)
    # the HDF5 file also reads through the store's interface
    with open_feature_store(str(back)) as db:
        buf = np.empty(db.shape(SCENE), db.dtype(SCENE))
        _same(db.read_into(SCENE, buf), arrays[SCENE], SCENE)


def test_hdf5_without_h5py_names_the_converter(tmp_path, monkeypatch):
    path = tmp_path / "feats.hdf5"
    with h5py.File(path, "w") as db:
        db["x"] = np.zeros(2)
    real_import = builtins.__import__

    def no_h5py(name, *args, **kwargs):
        if name == "h5py":
            raise ImportError("No module named 'h5py'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_h5py)
    monkeypatch.delitem(sys.modules, "h5py")
    with pytest.raises(ImportError,
                       match="scan2cap_torch.scripts.convert_feature_db"):
        open_feature_store(str(path))
    with pytest.raises(ImportError, match="convert_feature_db"):
        FeatureStoreWriter(str(tmp_path / "out.h5"))
    # the store itself needs no h5py
    _write(tmp_path / "ok.npz", {"x": np.arange(3)})
    with open_feature_store(str(tmp_path / "ok.npz")) as db:
        np.testing.assert_array_equal(db["x"], np.arange(3))


def test_multiview_path_prefers_the_store(tmp_path, monkeypatch):
    monkeypatch.setenv("SCAN2CAP_DATA", str(tmp_path))
    paths = config.PathConfig()
    assert paths.multiview.endswith("enet_feats_maxpool.hdf5")
    scannet = tmp_path / "scannet" / "scannet_data"
    scannet.mkdir(parents=True)
    _write(scannet / "enet_feats_maxpool.npz", {SCENE: np.zeros((2, 128))})
    assert paths.multiview == str(scannet / "enet_feats_maxpool.npz")


# --- the scene datasets' multiview read --------------------------------------
SCENES = ["scene0000_00", "scene0001_00"]


@pytest.fixture(scope="module")
def multiview_data(tmp_path_factory):
    path = tmp_path_factory.mktemp("mv_scannet")
    rng = np.random.RandomState(0)
    mv = {}
    for i, s in enumerate(SCENES):
        make_fixture_scene(str(path), s, rng, n_points=1500 + 100 * i,
                           n_obj=3)
        mv[s] = rng.randn(1500 + 100 * i, 128).astype(np.float32)
    h5 = path / "enet_feats_maxpool.hdf5"
    with h5py.File(h5, "w") as db:
        for s, v in mv.items():
            db[s] = v
    npz = path / "enet_feats_maxpool.npz"
    convert_feature_db.convert(str(h5), str(npz))
    scanrefer = [{"scene_id": s, "object_id": str(o), "object_name": "chair",
                  "ann_id": str(a), "token": ["a", "red", "chair"]}
                 for s in SCENES for o in range(3) for a in range(2)]
    return (str(path), str(h5), str(npz), scanrefer,
            make_fixture_glove(["a", "red", "chair"]))


def _pair(multiview_data, jcls, tcls, **kw):
    path, h5, npz, scanrefer, glove = multiview_data
    args = dict(scannet_data_dir=path, glove_path="", glove=glove,
                num_points=1024, use_height=True, use_normal=True,
                use_multiview=True)
    args.update(kw)
    return (jcls(scanrefer, SCENES, multiview_path=h5, **args),
            tcls(scanrefer, SCENES, multiview_path=npz, **args))


def _equal(a, b, what):
    assert set(a) == set(b), what
    for k in a:
        if k == "load_time":
            continue
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, (what, k)
        np.testing.assert_array_equal(x, y, err_msg=f"{what}: {k}")


CLASSES = {
    "scene": (jdataset.ScannetReferenceDataset,
              dataset.ScannetReferenceDataset),
    "mask": (jmask_dataset.MaskScannetReferenceDataset,
             dataset_maskvotenet.MaskScannetReferenceDataset),
}


@pytest.mark.parametrize("kind", sorted(CLASSES))
@pytest.mark.parametrize("augment", [False, True])
def test_multiview_items_from_the_store_match_jax_from_hdf5(
        multiview_data, kind, augment):
    jds, ds = _pair(multiview_data, *CLASSES[kind], augment=augment)
    for i in range(len(ds)):
        want = jds.__getitem__(i, np.random.RandomState(i))
        got = ds.__getitem__(i, np.random.RandomState(i))
        _equal(want, got, f"{kind} item {i}")
        assert got["point_clouds"].shape[-1] == (3 + 3 + 128 + 1
                                                 + (kind == "mask"))


@pytest.mark.parametrize("kind", sorted(CLASSES))
def test_multiview_loader_batches_match_jax(multiview_data, kind):
    jds, ds = _pair(multiview_data, *CLASSES[kind], augment=True)
    jl = jdataset.Loader(jds, batch_size=2, shuffle=True, seed=3,
                         num_workers=4)
    tl = dataset.Loader(ds, batch_size=2, shuffle=True, seed=3,
                        num_workers=4)
    for epoch in range(2):
        got, want = list(tl), list(jl)
        assert len(got) == len(want) > 0
        for b, (x, y) in enumerate(zip(want, got)):
            _equal(x, y, f"{kind} epoch {epoch} batch {b}")
    jl.close()
    tl.close()
