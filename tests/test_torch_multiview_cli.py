"""The port's three multiview entry points against the JAX package's scripts,
on the CPU, on a fixture like ``tests/test_cli_multiview.py``'s: two rooms
of 3,000 points, six poses each looking at the room (``chip_smoke.
write_frames``: 80 x 64 PNG colour, 41 x 32 16-bit PNG depth rendered from
the room's own points, so that the visible points pass the depth check).

* ``compute_multiview_features`` with one reference-layout
  ``scannetv2_enet.pth`` (random weights, ``tests/test_convert_enet.py``'s
  ``build_reference_enet``) against
  ``scripts/compute_multiview_features.py``: the same files, each (128,
  32, 41) within 1e-4 of its largest value; ``--ckpt``
  with the converted weights gives the ``--enet_pth`` features exactly.
* ``project_multiview_features`` against ``scripts/project_multiview_
  features.py`` on the same features, with ``--maxpool`` and without: the
  port's store equals the JAX script's HDF5 key for key and bitwise, once
  ``convert_feature_db`` has turned the HDF5 into a store.
* ``project_multiview_labels`` against ``scripts/project_multiview_labels.
  py``: the same PLY, byte for byte.
"""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from tests.test_convert_enet import _randomize, build_reference_enet

from scan2cap_torch.convert import convert_enet_checkpoint
from scan2cap_torch.data.feature_store import open_feature_store
from scan2cap_torch.scripts import (compute_multiview_features,
                                    convert_feature_db,
                                    project_multiview_features,
                                    project_multiview_labels)

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = ("scene0000_00", "scene0001_00")
FRAMES = 6


def _jax_main(name, argv, monkeypatch):
    monkeypatch.syspath_prepend(os.path.join(REPO, "scripts"))
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    module.main()


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    root = tmp_path_factory.mktemp("multiview")
    rs = np.random.RandomState(0)
    scannet = root / "scannet_data"
    scannet.mkdir()
    for k, sid in enumerate(SCENES):
        verts = np.zeros((3000, 9), np.float32)
        verts[:, :2] = rs.uniform(-3, 3, (3000, 2))
        verts[:, 2] = rs.uniform(0, 2, 3000)
        np.save(scannet / f"{sid}_aligned_vert.npy", verts)
        chip_smoke.write_frames(np, str(root / "frames"), sid, verts, FRAMES,
                                seed=k, color_size=(80, 64))
    model = build_reference_enet()
    _randomize(model)
    pth = root / "scannetv2_enet.pth"
    torch.save(model.state_dict(), str(pth))
    return root


@pytest.fixture(scope="module")
def features(fixture):
    out = fixture / "port_feats"
    compute_multiview_features.main(
        ["--frames_root", str(fixture / "frames"), "--out_root", str(out),
         "--enet_pth", str(fixture / "scannetv2_enet.pth"), "--batch_size",
         str(FRAMES), "--device", "cpu"])
    return out


def test_compute_features_matches_the_jax_script(fixture, features,
                                                 monkeypatch):
    jax_out = fixture / "jax_feats"
    _jax_main("compute_multiview_features",
              ["--frames_root", str(fixture / "frames"), "--out_root",
               str(jax_out), "--enet_pth", str(fixture / "scannetv2_enet.pth"),
               "--batch_size", str(FRAMES)], monkeypatch)
    for sid in SCENES:
        names = sorted(os.listdir(jax_out / sid))
        assert names == sorted(os.listdir(features / sid))
        assert len(names) == FRAMES
        for name in names:
            want = np.load(jax_out / sid / name)
            got = np.load(features / sid / name)
            assert got.dtype == want.dtype == np.float32
            assert got.shape == want.shape == (128, 32, 41)
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-4 * np.abs(want).max())
    # --ckpt: a torch.save state dict of the port's ENetEncoder
    ckpt = fixture / "enet.pt"
    torch.save(convert_enet_checkpoint(str(fixture / "scannetv2_enet.pth")),
               str(ckpt))
    again = fixture / "ckpt_feats"
    compute_multiview_features.main(
        ["--frames_root", str(fixture / "frames"), "--out_root", str(again),
         "--ckpt", str(ckpt), "--batch_size", "4", "--device", "cpu"])
    for sid in SCENES:
        for name in os.listdir(features / sid):
            np.testing.assert_array_equal(np.load(again / sid / name),
                                          np.load(features / sid / name))


@pytest.mark.parametrize("maxpool,skip", [(True, 2), (False, 1)])
def test_projected_store_equals_the_jax_hdf5(fixture, features, monkeypatch,
                                             maxpool, skip):
    tag = f"{int(maxpool)}_{skip}"
    args = ["--scannet_data", str(fixture / "scannet_data"), "--frames_root",
            str(fixture / "frames"), "--features_root", str(features),
            "--frame_skip", str(skip)] + (["--maxpool"] if maxpool else [])
    h5 = fixture / f"jax_{tag}.hdf5"
    _jax_main("project_multiview_features", args + ["--out", str(h5)],
              monkeypatch)
    port = fixture / f"port_{tag}.npz"
    project_multiview_features.main(args + ["--out", str(port)])
    converted = fixture / f"converted_{tag}.npz"
    convert_feature_db.convert(str(h5), str(converted))
    with open_feature_store(str(port)) as got, \
            open_feature_store(str(converted)) as want:
        assert sorted(got.keys()) == sorted(want.keys()) == list(SCENES)
        for k in SCENES:
            a, b = got[k], want[k]
            assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
            assert a.tobytes() == b.tobytes(), k
            covered = np.abs(a).max(-1) > 0
            assert 100 < covered.sum() < len(a), k


def test_label_projection_equals_the_jax_script(fixture, monkeypatch):
    sid = SCENES[0]
    labels = fixture / "labels" / sid
    labels.mkdir(parents=True)
    rs = np.random.RandomState(3)
    for i in range(FRAMES):
        np.save(labels / f"{i:06d}.npy", rs.randint(0, 41, (32, 41)))
    args = ["--scannet_data", str(fixture / "scannet_data"), "--frames_root",
            str(fixture / "frames"), "--labels_root", str(fixture / "labels"),
            "--scene_id", sid, "--frame_skip", "1"]
    _jax_main("project_multiview_labels",
              args + ["--out", str(fixture / "jax.ply")], monkeypatch)
    project_multiview_labels.main(args + ["--out", str(fixture / "port.ply")])
    want = (fixture / "jax.ply").read_bytes()
    assert (fixture / "port.ply").read_bytes() == want
    assert len(want) > 3000 * 15


def test_entry_points_default_to_the_card_and_the_store():
    args = compute_multiview_features.build_parser().parse_args(
        ["--frames_root", "f", "--out_root", "o"])
    assert args.device == "cuda" and args.batch_size == 64
    args = project_multiview_features.build_parser().parse_args(
        ["--scannet_data", "s", "--frames_root", "f", "--features_root", "x"])
    assert args.out is None and args.frame_skip == 20 and not args.maxpool
