"""The tools around a trained run, against the JAX package's, on the CPU.

* ``utils``: ``read_ply`` (ascii and binary, vertex properties of every
  PLY type, list-valued faces) against ``scan2cap_tpu.utils.ply.read_ply``;
  ``compute_normals``, ``write_bbox_ply`` (the file's bytes) and
  ``object_color`` bit for bit against the JAX functions.
* ``scripts/export_pth.py`` in process on a run that ``test_torch_cli.py``'s
  pattern trains with ``--device cpu`` at the ``SCAN2CAP_TEST_TINY`` sizes:
  ``model.pth`` read back through the JAX package's
  ``convert_capnet_checkpoint`` equals the port's weights carried through
  ``flax_from_state_dict``, bit for bit; so does ``--detection_only``'s
  ``votenet.pth``, and a vocabulary-padded run exported with
  ``--num_vocabs`` equals the JAX exporter's file key for key.
* ``scripts/visualize.py`` with ``--device cpu`` on the same run: the JAX
  script's file set, and its kept proposals, ``captions.json`` and the
  scene's and GT boxes' PLY bytes equal to the JAX script's logic
  (``scripts/visualize.py:30-137``, written out here over the JAX package's
  functions) on the same weights carried across; the predicted boxes'
  PLYs have the same header and colours, and corners within 1e-4 of
  JAX's (the forward's tolerance: its float32 sums are taken in another
  order, so corners are not bitwise).  The proposal head's
  objectness bias is raised in the checkpoint first, so that proposals
  pass the objectness gate and NMS has work.
"""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from scan2cap_tpu import convert as jconvert
from scan2cap_tpu.config import Config, MEAN_COLOR_RGB
from scan2cap_tpu.config import ModelConfig as JModelConfig
from scan2cap_tpu.data.dataset import ScannetReferenceDataset as JDataset
from scan2cap_tpu.data.dataset import get_scanrefer as jget_scanrefer
from scan2cap_tpu.eval.eval_helper import decode_caption as jdecode
from scan2cap_tpu.models import CapNet as JCapNet
from scan2cap_tpu.ops.nms import nms_3d as jnms_3d
from scan2cap_tpu.train import make_eval_step as jmake_eval_step
from scan2cap_tpu.train.step import TrainState as JTrainState
from scan2cap_tpu.utils import colors as jcolors
from scan2cap_tpu.utils import pc_utils as jpc
from scan2cap_tpu.utils import ply as jply

from tests.test_torch_cli import FLAGS, TINY, _run, write_cli_data

from scan2cap_torch import convert
from scan2cap_torch.models import CapNet
from scan2cap_torch.scripts import export_pth, visualize
from scan2cap_torch.scripts import train as traincli
from scan2cap_torch.train.checkpoints import CheckpointIO, model_bundle
from scan2cap_torch.utils import colors, pc_utils, ply


# --- utils ------------------------------------------------------------------
def _ascii_ply(path, rs, faces=True):
    n = 7
    rows = []
    for i in range(n):
        rows.append(f"{rs.randn():.6f} {rs.randn():.9g} {rs.rand() * 9:.3f} "
                    f"{rs.randint(0, 256)} {rs.randint(0, 256)} "
                    f"{rs.randint(0, 256)} {rs.randint(-5, 5)} "
                    f"{rs.randn():.17g}")
    header = ["ply", "format ascii 1.0", "comment written by hand",
              f"element vertex {n}", "property float x", "property float y",
              "property float z", "property uchar red",
              "property uchar green", "property uchar blue",
              "property short label", "property double quality"]
    body = rows
    if faces:
        header += ["element face 3", "property list uchar int vertex_indices"]
        body = rows + ["3 0 1 2", "3 2 3 4", "3 4 5 6"]
    with open(path, "w") as f:
        f.write("\n".join(header + ["end_header"] + body) + "\n")


def _binary_ply(path, rs):
    dt = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                   ("red", "u1"), ("green", "u1"), ("blue", "u1"),
                   ("alpha", "u1"), ("id", "<u4"), ("w", "<f8")])
    v = np.zeros(11, dt)
    for name in dt.names:
        v[name] = (rs.randn(11) * 100).astype(dt[name]) \
            if dt[name].kind == "f" else rs.randint(0, 200, 11)
    faces = rs.randint(0, 11, (5, 3)).astype(np.int32)
    header = ["ply", "format binary_little_endian 1.0", "element vertex 11"]
    header += [f"property {t} {n}" for n, t in zip(
        dt.names, ["float", "float", "float", "uchar", "uchar", "uchar",
                   "uchar", "uint", "double"])]
    header += ["element face 5", "property list uchar int vertex_indices",
               "end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(v.tobytes())
        for face in faces:
            f.write(np.uint8(3).tobytes() + face.astype("<i4").tobytes())


@pytest.mark.parametrize("kind", ["ascii", "ascii_no_faces", "binary",
                                  "written"])
def test_read_ply_equals_jax(tmp_path, kind):
    rs = np.random.RandomState(0)
    path = str(tmp_path / "m.ply")
    if kind.startswith("ascii"):
        _ascii_ply(path, rs, faces=kind == "ascii")
    elif kind == "binary":
        _binary_ply(path, rs)
    else:
        ply.write_ply(path, rs.randn(20, 3).astype(np.float32),
                      rs.randint(0, 256, (20, 3)).astype(np.uint8),
                      rs.randint(0, 20, (6, 3)))
    got, want = ply.read_ply(path), jply.read_ply(path)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].tobytes() == want[k].tobytes(), k


def test_compute_normals_equals_jax():
    rs = np.random.RandomState(1)
    verts = rs.randn(300, 3)
    faces = rs.randint(0, 300, (900, 3))
    faces[:5] = faces[0]                    # degenerate faces, repeated
    got = pc_utils.compute_normals(verts, faces)
    want = jpc.compute_normals(verts, faces)
    assert got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("color", [(0, 255, 0), (12, 34, 56)])
def test_write_bbox_ply_equals_jax(tmp_path, color):
    corners = np.random.RandomState(2).randn(3, 8, 3)
    pc_utils.write_bbox_ply(str(tmp_path / "a.ply"), corners, color=color)
    jpc.write_bbox_ply(str(tmp_path / "b.ply"), corners, color=color)
    assert (tmp_path / "a.ply").read_bytes() == (tmp_path / "b.ply").read_bytes()


def test_object_color_equals_jax():
    for oid in list(range(120)) + [np.int64(7), 4095]:
        assert colors.object_color(oid) == jcolors.object_color(oid)


# --- a trained run ----------------------------------------------------------
@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A tiny full run (graph + top-down caption) and a detection-only one,
    trained once for the module on ``test_torch_cli.py``'s fixture data,
    torch on one thread.  The full run's best checkpoint is its last with
    the objectness logit raised by 4, so that proposals pass visualize's
    objectness gate, and boxes nine times their class's mean size, of one
    class, so that they overlap and NMS suppresses some."""
    root = tmp_path_factory.mktemp("tools")
    data = write_cli_data(root, np.random.RandomState(0))
    outputs = root / "outputs"
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SCAN2CAP_DATA", str(data))
        mp.setenv("SCAN2CAP_OUTPUT", str(outputs))
        mp.setenv("SCAN2CAP_TEST_TINY", "1")
        traincli.main(TINY + FLAGS + ["--epoch", "1", "--val_step", "100",
                                      "--tag", "full"])
        traincli.main(TINY + ["--epoch", "1", "--no_caption", "--tag",
                              "det"])
        full, det = _run(outputs, "_FULL"), _run(outputs, "_DET")
        ckpt = CheckpointIO(str(full / "ckpt"))
        sd = ckpt.restore("last")["model"]
        bias = sd["proposal.conv3.bias"]     # (2 + 3 + 2 + 18 * 4 + 18,)
        bias[1] += 4.0                        # objectness
        bias[25:79] += 8.0                    # size residuals, x mean size
        bias[79] += 6.0                       # semantic class 0
        ckpt.save("best", {"model": sd})
        yield dict(outputs=outputs, full=full, det=det, sd=sd)
    torch.set_num_threads(threads)


def _jax_tree(path, num_vocabs_padded=None):
    """A .pth through the JAX converter, named as the port names it."""
    return convert.state_dict_from_flax(*jconvert.convert_capnet_checkpoint(
        str(path), num_vocabs_padded))


def _flax_named(sd):
    """The port's weights carried through the Flax tree and back."""
    return convert.state_dict_from_flax(*convert.flax_from_state_dict(sd))


def _equal_trees(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


def test_export_pth_reads_back_through_the_jax_converter(trained):
    out = export_pth.main(["--folder", trained["full"].name])
    assert out == str(trained["full"] / "model.pth")
    # best.pt (the raised objectness bias), carried both ways
    _equal_trees(_jax_tree(out), _flax_named(trained["sd"]))
    ref = torch.load(out, weights_only=True)
    assert any(k.startswith("caption.") for k in ref)
    back = convert.state_dict_from_reference(ref)
    assert all(torch.equal(back[k], trained["sd"][k]) for k in back)
    # --use_last takes last.pt
    last = CheckpointIO(str(trained["full"] / "ckpt")).restore("last")["model"]
    out = export_pth.main(["--folder", trained["full"].name, "--use_last",
                           "--out", str(trained["outputs"] / "last.pth")])
    _equal_trees(_jax_tree(out), _flax_named(last))


def test_export_pth_detection_only(trained):
    # a detection-only run, and a full run with --detection_only
    det_sd = CheckpointIO(str(trained["det"] / "ckpt")).restore_best_or_last(
        )["model"]
    out = export_pth.main(["--folder", trained["det"].name])
    assert out == str(trained["det"] / "votenet.pth")
    _equal_trees(_jax_tree(out), _flax_named(det_sd))
    out = export_pth.main(["--folder", trained["full"].name,
                           "--detection_only"])
    assert out == str(trained["full"] / "votenet.pth")
    ref = torch.load(out, weights_only=True)
    assert not any(k.split(".")[0] in ("caption", "graph") for k in ref)
    want = {k: v for k, v in trained["sd"].items()
            if k.split(".")[0] in convert.DETECTION_MODULES}
    _equal_trees(_jax_tree(out), _flax_named(want))
    # the JAX exporter writes the same file, key for key
    params, stats = convert.flax_from_state_dict(want)
    jsd = jconvert.export_votenet_checkpoint(params, stats)
    assert set(jsd) == set(ref)
    assert all(torch.equal(ref[k], jsd[k]) for k in jsd)


def test_export_pth_slices_a_vocabulary_padded_run(trained):
    cfg = traincli.model_config_from_info(json.loads(
        (trained["full"] / "info.json").read_text()))
    V = trained["sd"]["caption.classifier.weight"].shape[0]
    model = CapNet(cfg, num_vocabs=V, num_vocabs_padded=V + 5, device="cpu",
                   seed=3)
    with torch.no_grad():     # pad rows as the converter pads them: zeros
        model.caption.classifier.weight[V:] = 0.0
        model.caption.classifier.bias[V:] = 0.0
    run = trained["outputs"] / "padded"
    CheckpointIO(str(run / "ckpt")).save("best", model_bundle(model))
    assert model.state_dict()["caption.classifier.weight"].shape[0] == V + 5
    out = export_pth.main(["--folder", "padded", "--num_vocabs", str(V)])
    ref = torch.load(out, weights_only=True)
    assert ref["caption.classifier.weight"].shape[0] == V
    params, stats = convert.flax_from_state_dict(model.state_dict())
    want = jconvert.export_capnet_checkpoint(params, stats, num_vocabs=V)
    assert set(want) == set(ref)
    assert all(torch.equal(ref[k], want[k]) for k in want)
    # and it reads back padded through the JAX converter
    _equal_trees(_jax_tree(out, V + 5), _flax_named(model.state_dict()))


def _jax_visualize(folder, scene_id, sd, out_dir, seed=42):
    """scripts/visualize.py's body over the JAX package, on the weights
    ``sd`` carried across."""
    from scan2cap_torch.config import PathConfig
    paths = PathConfig()
    with open(os.path.join(folder, "info.json")) as f:
        info = json.load(f)
    pcfg = traincli.model_config_from_info(info)
    mcfg = JModelConfig(**{k: getattr(pcfg, k) for k in
                           pcfg.__dataclass_fields__})
    cfg = Config(model=mcfg)
    train_path = os.path.join(paths.data, "ScanRefer_filtered_train.json")
    val_path = os.path.join(paths.data, "ScanRefer_filtered_val.json")
    scanrefer_train, _, _, all_scenes = jget_scanrefer(train_path, val_path)
    with open(val_path) as f:
        entries = [d for d in json.load(f) if d["scene_id"] == scene_id]
    common = dict(
        scannet_data_dir=paths.scannet_data, glove_path=paths.glove,
        num_points=mcfg.num_points, use_height=mcfg.use_height,
        use_color=mcfg.use_color, use_normal=mcfg.use_normal,
        use_multiview=mcfg.use_multiview, multiview_path=paths.multiview)
    train_ds = JDataset(scanrefer_train, all_scenes, split="train",
                        augment=False, **common)
    ds = JDataset(entries[:1], all_scenes, split="val", augment=False,
                  vocab=train_ds.vocabulary, glove=train_ds.glove, **common)
    sample = ds.__getitem__(0, rs=np.random.RandomState(seed))
    batch = {k: jnp.asarray(v)[None] for k, v in sample.items()}
    batch["glove_emb_table"] = jnp.asarray(train_ds.emb_table)
    model = JCapNet(mcfg, num_vocabs=train_ds.num_vocabs)
    params, stats = convert.flax_from_state_dict(sd)
    state = JTrainState(step=jnp.zeros((), jnp.int32),
                        params=jax.tree.map(jnp.asarray, params),
                        batch_stats=jax.tree.map(jnp.asarray, stats),
                        opt_state=(), tx=None)
    out = jmake_eval_step(cfg, model, detection_loss=True)(state, batch)
    obj_prob = jax.nn.softmax(out["objectness_scores"], -1)[..., 1]
    cls = jnp.argmax(out["sem_cls_scores"], -1)
    keep = jnms_3d(out["bbox_corner"], obj_prob, cls, 0.25, True)
    keep = np.asarray(keep & (jnp.argmax(out["objectness_scores"], -1)
                              == 1))[0]
    corners = np.asarray(out["bbox_corner"])[0]
    caps = np.asarray(out["lang_cap"])[0]
    os.makedirs(out_dir)
    pc = np.asarray(sample["point_clouds"])
    rgb = ((pc[:, 3:6] * 256.0 + MEAN_COLOR_RGB).clip(0, 255).astype(np.uint8)
           if mcfg.use_color else np.full((len(pc), 3), 180, np.uint8))
    jply.write_ply(os.path.join(out_dir, "scene.ply"), pc[:, :3], rgb)
    det_ids = np.asarray(sample["scene_object_ids"])
    if keep.any():
        jpc.write_bbox_ply(os.path.join(out_dir, "pred_boxes.ply"),
                           corners[keep], color=(0, 255, 0))
        assignment = np.asarray(out["object_assignment"][0]).astype(int)
        for k in np.where(keep)[0]:
            oid = int(det_ids[assignment[k]])
            jpc.write_bbox_ply(os.path.join(out_dir, f"pred-{oid}.ply"),
                               corners[k][None],
                               color=jcolors.object_color(oid))
    gt_mask = np.asarray(sample["gt_box_masks"]) == 1
    gt_corners = np.asarray(sample["gt_box_corner_label"])
    jpc.write_bbox_ply(os.path.join(out_dir, "gt_boxes.ply"),
                       gt_corners[gt_mask], color=(0, 0, 255))
    for i in np.where(gt_mask)[0]:
        oid = int(np.asarray(sample["gt_box_object_ids"])[i])
        jpc.write_bbox_ply(os.path.join(out_dir, f"gt-{oid}.ply"),
                           gt_corners[i][None],
                           color=jcolors.object_color(oid))
    captions = {str(int(k)): jdecode(caps[k], ds.vocabulary["idx2word"])
                for k in np.where(keep)[0]}
    with open(os.path.join(out_dir, "captions.json"), "w") as f:
        json.dump(captions, f, indent=4)
    return keep


def test_visualize_equals_the_jax_script(trained, tmp_path):
    scene = "scene0001_00"
    out_dir = visualize.main(["--folder", trained["full"].name, "--scene_id",
                              scene, "--device", "cpu"])
    assert out_dir == str(trained["full"] / "vis" / scene)
    keep = _jax_visualize(str(trained["full"]), scene, trained["sd"],
                          str(tmp_path / "jax"))
    names = sorted(os.listdir(out_dir))
    assert names == sorted(os.listdir(tmp_path / "jax"))
    assert {"scene.ply", "gt_boxes.ply", "captions.json"} <= set(names)
    # NMS kept some proposals and suppressed others
    assert 0 < keep.sum() < len(keep), keep
    assert "pred_boxes.ply" in names
    assert any(n.startswith("pred-") for n in names)
    assert any(n.startswith("gt-") for n in names)
    caps = json.loads(open(os.path.join(out_dir, "captions.json")).read())
    assert sorted(map(int, caps)) == np.flatnonzero(keep).tolist()
    for n in names:
        with open(os.path.join(out_dir, n), "rb") as g, \
                open(tmp_path / "jax" / n, "rb") as w:
            got, want = g.read(), w.read()
        if not n.startswith("pred"):
            assert got == want, n
            continue
        # predicted boxes: the header and colours bit for bit; the corners
        # within the forward's tolerance against JAX (its float32 sums are
        # taken in another order, tests/test_torch_capnet.py)
        head = want.index(b"end_header\n") + len(b"end_header\n")
        assert got[:head] == want[:head], n
        g, w = (ply.read_ply(os.path.join(d, n))["vertex"]
                for d in (out_dir, str(tmp_path / "jax")))
        for c in ("red", "green", "blue"):
            np.testing.assert_array_equal(g[c], w[c], err_msg=n)
        xyz = [np.stack([v[c] for c in "xyz"], 1) for v in (g, w)]
        np.testing.assert_allclose(xyz[0], xyz[1], rtol=1e-4,
                                   atol=1e-4 * np.abs(xyz[1]).max(),
                                   err_msg=n)


def test_visualize_refuses_a_scene_outside_val(trained):
    with pytest.raises(SystemExit, match="not in val split"):
        visualize.main(["--folder", trained["full"].name, "--scene_id",
                        "scene0000_00", "--device", "cpu"])
    assert visualize.build_parser().parse_args(
        ["--folder", "x", "--scene_id", "y"]).device == "cuda"

