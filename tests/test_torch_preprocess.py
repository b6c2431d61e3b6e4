"""The port's dataset preparation against the JAX package's, on the CPU.

Mirrors ``tests/test_scannet_preprocess.py`` (``export``'s semantics,
``batch_export``'s class filter and point cap) and
``tests/test_cli_tools.py:29-155`` (the organizers, Scan2CAD's rotations,
the preprocessed-scene check, the GT-box PLYs, the axis-aligned mesh) on
``scan2cap_torch``: the same synthetic inputs go through the JAX function
or script and through the port's, and every file each writes is compared
byte for byte (``.npy``, PLY, JSON).  The port's Nr3D organizer parses the
CSV without pandas; it is held to the pandas-based JAX script on a CSV with
quoted commas, quotes, a line break inside a field and list-valued token
columns, and run with pandas blocked.
"""

import csv
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from scan2cap_tpu.data import scannet_preprocess as jprep
from tests.test_cli_end_to_end import REPO
from tests.test_dataset import make_fixture_scene
from tests.test_scannet_preprocess import make_label_map, make_raw_scene

from scan2cap_torch.config import SCANNET_NYU40IDS
from scan2cap_torch.data import scannet_preprocess as prep
from scan2cap_torch.scripts import (check_preprocessed_scene,
                                    export_scannet_axis_aligned_mesh,
                                    organize_referit3d, organize_scanrefer,
                                    scan2cad_to_scannet, visualize_gt_bbox)


def _jax_script(name, args):
    """Run the JAX package's ``scripts/<name>.py`` as its tests do."""
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, os.path.join(REPO, "scripts",
                                                       f"{name}.py"), *args],
                         env=env, capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-3000:]


def _same_files(got_dir, want_dir, names=None):
    names = sorted(names or os.listdir(want_dir))
    assert sorted(os.listdir(got_dir)) == sorted(os.listdir(want_dir))
    for n in names:
        with open(os.path.join(got_dir, n), "rb") as g, \
                open(os.path.join(want_dir, n), "rb") as w:
            assert g.read() == w.read(), n


def _scene(tmp_path, n=60):
    scene = "scene0000_00"
    xyz = make_raw_scene(tmp_path / "scans", scene, np.random.RandomState(0),
                         n=n)
    tsv = tmp_path / "labels.tsv"
    make_label_map(tsv)
    return scene, xyz, tsv, tmp_path / "scans" / scene / scene


def test_export_semantics(tmp_path):
    scene, xyz, tsv, base = _scene(tmp_path)
    files = (str(base) + "_vh_clean_2.ply", str(base) + ".aggregation.json",
             str(base) + "_vh_clean_2.0.010000.segs.json", str(base) + ".txt",
             str(tsv))
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    got = prep.export(*files, output_file=str(tmp_path / "port" / scene))
    want = jprep.export(*files, output_file=str(tmp_path / "jax" / scene))
    verts, aligned, sem, ins, bboxes, abboxes = got
    # tests/test_scannet_preprocess.py's semantics on the port
    assert verts.shape == (60, 9)
    np.testing.assert_allclose(aligned[:, 0], verts[:, 0] + 10.0, atol=1e-5)
    np.testing.assert_array_equal(np.unique(ins), [0, 1, 2])
    assert (ins[10:20] == 1).all() and (ins[30:45] == 2).all()
    assert (sem[10:20] == 5).all() and (sem[30:45] == 1).all()
    assert (sem[:10] == 0).all()
    lo, hi = xyz[10:20].min(0), xyz[10:20].max(0)
    np.testing.assert_allclose(bboxes[0, :3], (lo + hi) / 2, atol=1e-5)
    np.testing.assert_allclose(bboxes[0, 3:6], hi - lo, atol=1e-5)
    assert bboxes[0, 6] == 5 and bboxes[0, 7] == 0
    assert abboxes[1, 6] == 1 and abboxes[1, 7] == 1
    # and the JAX package's arrays and files, bit for bit
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    _same_files(tmp_path / "port", tmp_path / "jax")


def test_batch_export_filters_and_caps(tmp_path):
    scene, _, tsv, _ = _scene(tmp_path, n=80)
    out, jout = tmp_path / "out", tmp_path / "jout"
    done = prep.batch_export(str(tmp_path / "scans"), str(out), str(tsv),
                             max_num_points=50)
    assert done == [scene]
    assert jprep.batch_export(str(tmp_path / "scans"), str(jout), str(tsv),
                              max_num_points=50) == [scene]
    bboxes = np.load(out / f"{scene}_bbox.npy")
    assert len(bboxes) == 1 and bboxes[0, 6] == 5
    assert 5 in SCANNET_NYU40IDS and 1 not in SCANNET_NYU40IDS
    assert len(np.load(out / f"{scene}_vert.npy")) == 50
    assert len(np.load(out / f"{scene}_ins_label.npy")) == 50
    _same_files(out, jout)
    # idempotent: a second run skips the scene it wrote
    assert prep.batch_export(str(tmp_path / "scans"), str(out), str(tsv),
                             max_num_points=50) == [scene]


def test_organize_scanrefer(tmp_path):
    entries = [
        {"scene_id": "scene0000_00", "object_id": "3", "ann_id": "0",
         "object_name": "chair", "token": ["a", "chair"],
         "description": "a chair"},
        {"scene_id": "scene0000_00", "object_id": "3", "ann_id": "1",
         "object_name": "chair", "token": ["the", "chair"],
         "description": "the chair"},
        {"scene_id": "scene0001_00", "object_id": "0", "ann_id": "0",
         "object_name": "table", "token": ["a", "table"],
         "description": "a table"},
    ]
    for d in ("port", "jax"):
        (tmp_path / d).mkdir()
        with open(tmp_path / d / "ScanRefer_filtered.json", "w") as f:
            json.dump(entries, f)
    organize_scanrefer.main(["--data", str(tmp_path / "port")])
    _jax_script("organize_scanrefer", ["--data", str(tmp_path / "jax")])
    _same_files(tmp_path / "port", tmp_path / "jax")
    org = json.loads((tmp_path / "port" /
                      "ScanRefer_filtered_organized.json").read_text())
    assert set(org["scene0000_00"]["3"]) == {"0", "1"}


NR3D_ROWS = [
    {"scan_id": "scene0000_00", "target_id": 2, "instance_type": "chair",
     "assignmentid": "A1", "utterance": "The RED chair, by the door",
     "tokens": "['the', 'red', 'chair', ',', 'by', 'the', 'door']"},
    {"scan_id": "scene0001_00", "target_id": 0,
     "instance_type": 'table, "old"', "assignmentid": "A2",
     "utterance": "a table\nnear the wall", "tokens": "['a', 'table']"},
    {"scan_id": "scene0001_00", "target_id": 11, "instance_type": "lamp",
     "assignmentid": "A3", "utterance": "",
     "tokens": "['the', \"lamp's\", 'shade']"},
]


def _nr3d(root, rows):
    with open(root / "nr3d.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]),
                           quoting=csv.QUOTE_MINIMAL)
        w.writeheader()
        w.writerows(rows)
    (root / "train.txt").write_text("scene0000_00\n")
    (root / "val.txt").write_text("scene0001_00\n")


@pytest.mark.parametrize("ids", ["text", "numbers"])
def test_organize_referit3d_equals_the_pandas_script(tmp_path, ids,
                                                     monkeypatch):
    rows = [dict(r) for r in NR3D_ROWS]
    if ids == "numbers":              # assignment ids pandas reads as ints
        for i, r in enumerate(rows):
            r["assignmentid"] = 1000 + i
    for d in ("port", "jax"):
        (tmp_path / d).mkdir()
        _nr3d(tmp_path / d, rows)
    args = ["--train_scenes", "train.txt", "--val_scenes", "val.txt"]

    def at(d):
        return ["--csv", str(tmp_path / d / "nr3d.csv"), "--data",
                str(tmp_path / d)] + [str(tmp_path / d / a)
                                      if a.endswith(".txt") else a
                                      for a in args]

    # pandas blocked: an import of it would raise
    monkeypatch.setitem(sys.modules, "pandas", None)
    organize_referit3d.main(at("port"))
    monkeypatch.delitem(sys.modules, "pandas")
    _jax_script("organize_referit3d", at("jax"))
    _same_files(tmp_path / "port", tmp_path / "jax")
    train = json.loads((tmp_path / "port" /
                        "ReferIt3D_filtered_train.json").read_text())
    assert train[0]["description"] == "the red chair, by the door"
    assert train[0]["token"][3] == ","
    org = json.loads((tmp_path / "port" / "nr3d_organized.json").read_text())
    assert set(org["scene0001_00"]) == {"0", "11"}


def test_organize_referit3d_never_imports_pandas(tmp_path):
    _nr3d(tmp_path, NR3D_ROWS)
    code = ("import sys\nsys.modules['pandas'] = None\n"
            "from scan2cap_torch.scripts import organize_referit3d as o\n"
            f"o.main(['--csv', {str(tmp_path / 'nr3d.csv')!r}, '--data', "
            f"{str(tmp_path)!r}])\n"
            "assert sys.modules['pandas'] is None\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   timeout=120)
    assert (tmp_path / "nr3d_organized.json").exists()


def test_scan2cad_to_scannet(tmp_path):
    s = np.sqrt(0.5)
    ann = [{"id_scan": "scene0000_00",
            "aligned_models": [
                {"trs": {"rotation": [s, 0.0, 0.0, s]}},
                {"trs": {"rotation": [1.0, 0.0, 0.0, 0.0]}},
                {"trs": {"rotation": [0.3, 0.1, -0.5, 0.2]}},   # no instance
            ]}]
    cad2inst = {"scene0000_00": {"0": 7, "1": 2}}
    for d in ("port", "jax"):
        (tmp_path / d).mkdir()
        with open(tmp_path / d / "full_annotations.json", "w") as f:
            json.dump(ann, f)
        with open(tmp_path / d / "aligned_cad2inst_id.json", "w") as f:
            json.dump(cad2inst, f)
    scan2cad_to_scannet.main(["--scan2cad", str(tmp_path / "port"), "--out",
                              str(tmp_path / "port" / "rot.json")])
    _jax_script("scan2cad_to_scannet", ["--scan2cad", str(tmp_path / "jax"),
                                        "--out",
                                        str(tmp_path / "jax" / "rot.json")])
    _same_files(tmp_path / "port", tmp_path / "jax")
    rot = json.loads((tmp_path / "port" / "rot.json").read_text())
    np.testing.assert_allclose(rot["scene0000_00"]["7"],
                               [[0, -1, 0], [1, 0, 0], [0, 0, 1]], atol=1e-6)


def test_scene_check_and_gt_bbox_plys(tmp_path):
    scannet = tmp_path / "data" / "scannet" / "scannet_data"
    scannet.mkdir(parents=True)
    make_fixture_scene(str(scannet), "scene0000_00", np.random.RandomState(0),
                       n_points=400)
    for name, mod, extra in (
            ("check_preprocessed_scene", check_preprocessed_scene,
             ["--scannet_data", str(scannet)]),
            ("visualize_gt_bbox", visualize_gt_bbox,
             ["--data", str(tmp_path / "data")])):
        args = ["--scene_id", "scene0000_00"] + extra
        mod.main(args + ["--out", str(tmp_path / name / "port")])
        _jax_script(name, args + ["--out", str(tmp_path / name / "jax")])
        _same_files(tmp_path / name / "port", tmp_path / name / "jax")
    from scan2cap_torch.utils.ply import read_ply
    pts = read_ply(str(tmp_path / "check_preprocessed_scene" / "port" /
                       "scene0000_00_points.ply"))["vertex"]
    assert len(pts["x"]) == 400


def test_export_axis_aligned_mesh(tmp_path):
    from scan2cap_torch.utils.ply import read_ply, write_ply

    rng = np.random.RandomState(0)
    scene = "scene0000_00"
    scan_dir = tmp_path / "scans" / scene
    scan_dir.mkdir(parents=True)
    xyz = rng.rand(50, 3).astype(np.float32)
    rgb = rng.randint(0, 255, (50, 3)).astype(np.uint8)
    faces = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
    write_ply(str(scan_dir / f"{scene}_vh_clean_2.ply"), xyz, rgb, faces)
    mat = np.eye(4)
    mat[:3, 3] = [1.0, 2.0, 3.0]
    mat[:3, :3] = [[0, -1, 0], [1, 0, 0], [0, 0, 1]]
    vals = " ".join(str(v) for v in mat.reshape(-1))
    (scan_dir / f"{scene}.txt").write_text(
        f"axisAlignment = {vals}\nnumColorFrames = 1\n")
    args = ["--scans", str(tmp_path / "scans"), "--scene_id", scene]
    export_scannet_axis_aligned_mesh.main(args + ["--out",
                                                  str(tmp_path / "port")])
    _jax_script("export_scannet_axis_aligned_mesh",
                args + ["--out", str(tmp_path / "jax")])
    _same_files(tmp_path / "port", tmp_path / "jax")
    data = read_ply(str(tmp_path / "port" / f"{scene}_aligned.ply"))
    got = np.stack([data["vertex"][c] for c in "xyz"], 1)
    want = xyz @ mat[:3, :3].T + [1, 2, 3]
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert len(data["face"]) == 2
