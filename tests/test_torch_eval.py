"""The port's evaluation path against the JAX package, on the CPU.

* ``ops.nms``: keep masks of ``nms_3d`` / ``nms_2d`` equal the jitted JAX
  ones on seeded boxes, exact duplicates (IoU 1), nested boxes, classes on
  and off, and exact score ties, where the higher proposal index is kept;
* ``eval.ap_helper``: ``parse_predictions_device`` on the same ``out``
  dict (masks and classes exact, probabilities within 1e-6), the host
  lists, and AP/AR at 0.25 and 0.5 within 1e-9;
* ``ops.boxes.box3d_iou_batch`` bitwise against jitted JAX on 20,000
  seeded pairs and at each call site: ``postprocess_scene_cap``,
  ``select_target`` and ``query_locals_for_targets``;
* ``eval.eval_helper``: ``postprocess_scene_cap`` (keep mask, detected
  ids and IoUs exact) with and without NMS, and ``feed_scene_cap``
  / ``eval_cap`` through a small CapNet on both top-down decode routes
  (local slots, full K), weights carried with ``state_dict_from_flax``:
  equal candidates, scores and intermediates;
* ``eval.capeval``: BLEU, CIDEr, ROUGE-L and METEOR on a seeded corpus, and
  a METEOR backend tag that says ``-stem`` only where a stemmer loaded.
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
from scan2cap_tpu.eval import ap_helper as jap
from scan2cap_tpu.eval import capeval as jcapeval
from scan2cap_tpu.eval import eval_helper as jeh
from scan2cap_tpu.models import CapNet as JCapNet
from scan2cap_tpu.ops import boxes as jboxes
from scan2cap_tpu.ops import nms as jnms
from scan2cap_tpu.train import step as jstep

from scan2cap_torch.config import ModelConfig
from scan2cap_torch.convert import state_dict_from_flax
from scan2cap_torch.data import synthetic
from scan2cap_torch.eval import ap_helper, capeval, eval_helper
from scan2cap_torch.models import CapNet
from scan2cap_torch.ops import boxes, nms
from scan2cap_torch.train.step import make_eval_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T_ = torch.from_numpy


def _corners(lo, hi):
    """(..., 3) extents -> (..., 8, 3) corners in the reference's order."""
    lo, hi = np.asarray(lo, np.float32), np.asarray(hi, np.float32)
    sx = np.array([1, 1, -1, -1, 1, 1, -1, -1], np.float32)
    sy = np.array([1, -1, -1, 1, 1, -1, -1, 1], np.float32)
    sz = np.array([1, 1, 1, 1, -1, -1, -1, -1], np.float32)
    size, center = hi - lo, (hi + lo) / 2
    return (center[..., None, :]
            + np.stack([sx, sy, sz], -1) * size[..., None, :] / 2
            ).astype(np.float32)


def _nms_case(name):
    """(corners (B, K, 8, 3), scores (B, K), classes (B, K)) of one case."""
    rs = np.random.RandomState(sum(map(ord, name)))
    if name == "seeded":
        B, K = 3, 64
        lo = rs.rand(B, K, 3) * 4
        c = _corners(lo, lo + 0.5 + rs.rand(B, K, 3))
        return c, rs.rand(B, K).astype(np.float32), rs.randint(0, 4, (B, K))
    if name == "duplicates":               # IoU exactly 1, distinct scores
        base = _corners([0, 0, 0], [1, 1, 1])
        c = np.stack([base, base, _corners([5, 5, 5], [6, 6, 6]), base])[None]
        return (c, np.array([[0.9, 0.8, 0.7, 0.95]], np.float32),
                np.zeros((1, 4), np.int64))
    if name == "nested":                   # a box inside a larger one
        c = np.stack([_corners([0, 0, 0], [2, 2, 2]),
                      _corners([0.1, 0.1, 0.1], [1.9, 1.9, 1.9]),
                      _corners([0.5, 0.5, 0.5], [0.9, 0.9, 0.9]),
                      _corners([0, 0, 0], [2, 2, 1.2])])[None]
        return (c, np.array([[0.6, 0.9, 0.8, 0.7]], np.float32),
                np.array([[1, 1, 1, 2]]))
    if name == "ties":                     # exact ties: the higher index wins
        B, K = 2, 48
        lo = rs.rand(B, K, 3) * 2
        c = _corners(lo, lo + 0.6 + rs.rand(B, K, 3))
        c[:, 1::3] = c[:, 0::3][:, :c[:, 1::3].shape[1]]   # duplicates
        s = rs.choice(np.float32([0.25, 0.5, 0.75]), (B, K)).astype(np.float32)
        return c, s, rs.randint(0, 2, (B, K))
    if name == "tie_pair":
        base = _corners([0, 0, 0], [1, 1, 1])
        return (np.stack([base, base])[None],
                np.array([[0.5, 0.5]], np.float32), np.zeros((1, 2), np.int64))
    if name == "full_width":               # K = 256, empty boxes at -1
        B, K = 2, 256
        lo = rs.rand(B, K, 3) * 5
        c = _corners(lo, lo + 0.3 + rs.rand(B, K, 3))
        s = rs.rand(B, K).astype(np.float32)
        s[:, rs.rand(K) < 0.2] = -1.0
        return c, s, rs.randint(0, 18, (B, K))
    raise KeyError(name)


NMS_CASES = ("seeded", "duplicates", "nested", "ties", "tie_pair",
             "full_width")


@pytest.mark.parametrize("same_cls", [True, False])
@pytest.mark.parametrize("case", NMS_CASES)
def test_nms_3d_matches_jax(case, same_cls):
    c, s, cls = _nms_case(case)
    cls = cls.astype(np.int32)
    want = np.asarray(jnms.nms_3d(jnp.asarray(c), jnp.asarray(s),
                                  jnp.asarray(cls), 0.25, same_cls))
    got = nms.nms_3d(T_(c), T_(s), T_(cls), 0.25, same_cls)
    assert got.dtype == torch.bool and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < want.size


@pytest.mark.parametrize("case", NMS_CASES)
def test_nms_2d_matches_jax(case):
    c, s, _ = _nms_case(case)
    want = np.asarray(jnms.nms_2d(jnp.asarray(c), jnp.asarray(s)))
    np.testing.assert_array_equal(nms.nms_2d(T_(c), T_(s)).numpy(), want)


@pytest.mark.parametrize("case", ["seeded", "full_width"])
def test_iou_matrix_rounds_as_jax(case):
    # iou > threshold decides NMS: the port's IoU must be XLA's, bit for bit
    c, _, _ = _nms_case(case)
    lo, hi = c.min(2), c.max(2)
    want = np.asarray(jax.jit(jax.vmap(jnms._aabb_iou_matrix))(
        jnp.asarray(lo), jnp.asarray(hi)))
    got = nms._aabb_iou_matrix(T_(lo), T_(hi)).numpy()
    np.testing.assert_array_equal(got, want)


def _box_pairs(n, seed):
    """n pairs of boxes (8 corners each, not axis-ordered), half of them
    jittered copies of each other: IoUs across (0, 1]."""
    rs = np.random.RandomState(seed)
    lo = rs.uniform(-2, 2, (2, n, 3)).astype(np.float32)
    hi = lo + rs.uniform(0.05, 2, (2, n, 3)).astype(np.float32)
    a, b = _corners(lo[0], hi[0]), _corners(lo[1], hi[1])
    half = n // 2
    b[:half] = a[:half] + rs.uniform(-0.3, 0.3, (half, 1, 3)).astype(
        np.float32)
    return a, b


def test_iou_batch_rounds_as_jax():
    a, b = _box_pairs(20000, 0)
    want = np.asarray(jax.jit(jboxes.box3d_iou_batch)(a, b))
    got = boxes.box3d_iou_batch(T_(a), T_(b)).numpy()
    assert (want > 0).sum() > 8000
    np.testing.assert_array_equal(got, want)               # 0 of 20,000
    # broadcast over the proposals, as select_target calls it
    a3, b3 = a[:4000].reshape(40, 100, 8, 3), b[:40]
    want = np.asarray(jax.jit(jboxes.box3d_iou_batch)(a3, b3[:, None]))
    np.testing.assert_array_equal(
        boxes.box3d_iou_batch(T_(a3), T_(b3)[:, None]).numpy(), want)


def _targets_case(seed, B=6, K=48):
    """Proposals jittered around a GT box per sample, overlaps straddling
    the 0.5 overlay gate, with masks and the targets' ids."""
    rs = np.random.RandomState(seed)
    lo = rs.uniform(-2, 2, (B, 1, 3)).astype(np.float32)
    hi = lo + rs.uniform(0.3, 1.5, (B, 1, 3)).astype(np.float32)
    size = hi - lo
    jit = rs.uniform(-0.35, 0.35, (B, K, 2, 3)).astype(np.float32) * size[:, :, None]
    corners = _corners(lo + jit[:, :, 0], hi + jit[:, :, 1])
    masks = (rs.rand(B, K) < 0.8).astype(np.float32)
    return corners, _corners(lo[:, 0], hi[:, 0]), masks


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_select_target_iou_matches_jax_bitwise(seed):
    from scan2cap_tpu.models import caption as jcaption
    from scan2cap_torch.models import caption
    corners, gt, _ = _targets_case(seed)
    d = {"bbox_corner": corners, "ref_box_corner_label": gt}
    jid, jiou = jax.jit(jcaption.select_target)(
        {k: jnp.asarray(v) for k, v in d.items()})
    tid, tiou = caption.select_target({k: T_(v) for k, v in d.items()})
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
    np.testing.assert_array_equal(tiou.numpy(), np.asarray(jiou))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_query_locals_iou_matches_jax_bitwise(seed):
    from scan2cap_tpu.models import caption as jcaption
    from scan2cap_torch.models import caption
    corners, _, masks = _targets_case(seed)
    tids = np.random.RandomState(seed).randint(0, corners.shape[1],
                                                corners.shape[0])
    want = jax.jit(jcaption.query_locals_for_targets, static_argnums=(3,))(
        jnp.asarray(corners), jnp.asarray(masks),
        jnp.asarray(tids, jnp.int32), 6)
    got = caption.query_locals_for_targets(T_(corners), T_(masks),
                                           T_(tids.astype(np.int32)), 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def overlay_iou(c, t):           # the IoU of that call, as it calls it
        tc = jnp.take_along_axis(c, t[:, None, None, None], axis=1)
        return jboxes.box3d_iou_batch(jnp.broadcast_to(tc, c.shape), c)
    want = np.asarray(jax.jit(overlay_iou)(jnp.asarray(corners),
                                           jnp.asarray(tids)))
    c = T_(corners)
    tc = c[torch.arange(c.shape[0]), T_(tids)][:, None]
    got = boxes.box3d_iou_batch(tc.expand_as(c), c).numpy()
    assert ((want > 0.3) & (want < 0.7)).sum() > 20     # near the gate
    np.testing.assert_array_equal(got, want)


def test_nms_known_answers():
    c, s, cls = _nms_case("duplicates")
    keep = nms.nms_3d(T_(c), T_(s), T_(cls)).numpy()
    np.testing.assert_array_equal(keep[0], [False, False, True, True])
    c, s, cls = _nms_case("tie_pair")
    np.testing.assert_array_equal(nms.nms_3d(T_(c), T_(s), T_(cls)).numpy(),
                                  [[False, True]])
    # the same footprint at another height: 2D NMS suppresses it, 3D not
    a, b = _corners([0, 0, 0], [1, 1, 1]), _corners([0, 0, 5], [1, 1, 6])
    c = np.stack([a, b])[None]
    s = np.array([[0.9, 0.8]], np.float32)
    np.testing.assert_array_equal(nms.nms_2d(T_(c), T_(s)).numpy(),
                                  [[True, False]])
    np.testing.assert_array_equal(
        nms.nms_3d(T_(c), T_(s), torch.zeros((1, 2), dtype=torch.int32)
                   ).numpy(), [[True, True]])


def test_suppression_matrix_only_looks_back():
    c, s, cls = _nms_case("seeded")
    order, sup = nms.suppression_matrix(T_(c), T_(s), T_(cls), 0.25, True)
    sup = sup.numpy()
    assert not np.tril(sup[0]).any()
    # the rank order visits scores from high to low
    ranked = np.take_along_axis(s, order.numpy(), axis=1)
    assert (np.diff(ranked, axis=1) <= 0).all()


def test_param2obb_batch_matches_jax():
    rs = np.random.RandomState(3)
    center = rs.randn(2, 16, 3).astype(np.float32)
    hc = rs.randint(0, 1, (2, 16)).astype(np.int32)
    hr = rs.randn(2, 16).astype(np.float32)
    sc = rs.randint(0, 18, (2, 16)).astype(np.int32)
    sr = rs.randn(2, 16, 3).astype(np.float32) * 0.1
    want = np.asarray(jax.jit(jboxes.param2obb_batch_jnp)(
        *map(jnp.asarray, (center, hc, hr, sc, sr))))
    got = boxes.param2obb_batch(*map(T_, (center, hc, hr, sc, sr))).numpy()
    assert got.shape == (2, 16, 7)
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ post-processing
def _scene_out(seed, B=2, K=32, N=600, M=6):
    """A model output dict and its batch (numpy) built around GT boxes:
    proposals are jittered copies of the GT boxes (with exact duplicates
    and exact score ties), boxes off in empty space, and boxes that hold
    fewer than 5 points."""
    rs = np.random.RandomState(seed)
    gt_lo = rs.rand(B, M, 3).astype(np.float32) * 4
    gt_hi = gt_lo + 0.4 + rs.rand(B, M, 3).astype(np.float32)
    gt = _corners(gt_lo, gt_hi)
    pts = np.concatenate([rs.uniform(gt_lo[:, m], gt_hi[:, m],
                                     (N // M, B, 3)).transpose(1, 0, 2)
                          for m in range(M)], 1).astype(np.float32)
    pc = np.concatenate([pts, rs.rand(B, pts.shape[1], 1)], -1
                        ).astype(np.float32)
    assign = rs.randint(0, M, (B, K))
    lo = np.take_along_axis(gt_lo, assign[..., None], 1)
    hi = np.take_along_axis(gt_hi, assign[..., None], 1)
    jit = rs.randn(B, K, 2, 3).astype(np.float32) * 0.08
    corners = _corners(lo + jit[:, :, 0], hi + jit[:, :, 1])
    corners[:, 1] = corners[:, 0]                    # an exact duplicate
    corners[:, 2:4] = _corners(np.full(3, 50.0), np.full(3, 51.0))  # empty
    pc[:, :3, :3] = 20.0 + rs.rand(B, 3, 3) * 0.1   # 3 points: too few
    far = pc[:, :3, :3]
    corners[:, 4] = _corners(far.min(1) - 1e-3, far.max(1) + 1e-3)
    obj = rs.randn(B, K, 2).astype(np.float32)
    obj[:, 1] = obj[:, 0]                            # an exact score tie
    sem = rs.randn(B, K, 18).astype(np.float32)
    sem[:, 1] = sem[:, 0]
    out = {"bbox_corner": corners, "objectness_scores": obj,
           "sem_cls_scores": sem, "object_assignment": assign.astype(np.int32),
           "lang_cap": rs.randint(0, 40, (B, K, 7)).astype(np.int32)}
    ids = np.tile(np.arange(M, dtype=np.int32) * 3 + 1, (B, 1))
    batch = {"point_clouds": pc, "scene_object_ids": ids,
             "gt_box_corner_label": gt, "box_label_mask": np.ones((B, M),
                                                                 np.float32),
             "sem_cls_label": rs.randint(0, 18, (B, M)).astype(np.int32)}
    return out, batch


@pytest.mark.parametrize("seed", [0, 1])
def test_parse_predictions_device_matches_jax(seed):
    out, batch = _scene_out(seed)
    d = {**out, "point_clouds": batch["point_clouds"]}
    want = jax.device_get(jap.parse_predictions_device(
        {k: jnp.asarray(v) for k, v in d.items()}))
    got = ap_helper.parse_predictions_device({k: T_(v) for k, v in d.items()})
    for k in ("pred_mask", "pred_sem_cls"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    for k in ("obj_prob", "sem_cls_probs"):
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=1e-6,
                                   rtol=0, err_msg=k)
    mask = got["pred_mask"].numpy()
    assert not mask[:, 2:5].any()                    # remove_empty_box
    assert mask.any() and not mask.all()
    # without the point cloud remove_empty_box keeps every box
    got2 = ap_helper.parse_predictions_device(
        {k: T_(v) for k, v in out.items()})
    want2 = jax.device_get(jap.parse_predictions_device(
        {k: jnp.asarray(v) for k, v in out.items()}))
    np.testing.assert_array_equal(got2["pred_mask"].numpy(),
                                  want2["pred_mask"])


def test_nonempty_boxes_counts_points_inside():
    pc = np.zeros((1, 7, 3), np.float32)
    pc[0, :5] = [[0.5, 0.5, 0.5]] * 4 + [[1.0, 1.0, 1.0]]   # 1.0 on the bound
    pc[0, 5:] = 3.0
    c = np.stack([_corners([0, 0, 0], [1, 1, 1]),
                  _corners([0, 0, 0], [0.9, 0.9, 0.9])])[None]
    got = ap_helper.nonempty_boxes(T_(c), T_(pc)).numpy()
    np.testing.assert_array_equal(got, [[True, False]])


@pytest.mark.parametrize("use_nms", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_postprocess_scene_cap_matches_jax(seed, use_nms):
    out, batch = _scene_out(seed)
    want = jax.device_get(jeh.postprocess_scene_cap(
        {k: jnp.asarray(v) for k, v in out.items()},
        {k: jnp.asarray(v) for k, v in batch.items()},
        min_iou=0.5, use_nms=use_nms))
    got = eval_helper.postprocess_scene_cap(
        {k: T_(v) for k, v in out.items()},
        {k: T_(v) for k, v in batch.items()}, min_iou=0.5, use_nms=use_nms)
    for k in ("keep", "detected_object_ids", "captions"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    # the IoU gates the keep mask: XLA's rounding, bit for bit
    np.testing.assert_array_equal(got["ious"].numpy(), want["ious"])
    keep = got["keep"].numpy()
    assert keep.any() and not keep.all()
    # the returned gates are what keep is made of
    nonempty, nms_mask = got["nonempty"].numpy(), got["nms_mask"].numpy()
    final = got["final_mask"].numpy()
    assert not (nms_mask & ~nonempty).any() and not (final & ~nms_mask).any()
    if not use_nms:
        np.testing.assert_array_equal(nms_mask, nonempty)
    np.testing.assert_array_equal(keep, final & (got["ious"].numpy() > 0.5))
    assert got["detected_object_ids"].dtype == torch.int32


def test_ap_host_lists_and_metrics_match_jax():
    calcs = {t: (jap.APCalculator(t), ap_helper.APCalculator(t))
             for t in (0.25, 0.5)}
    for seed in (0, 1, 2):
        out, batch = _scene_out(seed)
        d = {**out, "point_clouds": batch["point_clouds"]}
        jparsed = jax.device_get(jap.parse_predictions_device(
            {k: jnp.asarray(v) for k, v in d.items()}))
        tparsed = {k: v.numpy() for k, v in ap_helper.parse_predictions_device(
            {k: T_(v) for k, v in d.items()}).items()}
        for per_class in (True, False):
            want = jap.assemble_pred_map_cls(out["bbox_corner"], jparsed,
                                             per_class_proposal=per_class)
            got = ap_helper.assemble_pred_map_cls(
                out["bbox_corner"], tparsed, per_class_proposal=per_class)
            assert [len(x) for x in got] == [len(x) for x in want]
            for g, w in zip(sum(got, []), sum(want, [])):
                assert g[0] == w[0]
                np.testing.assert_array_equal(g[1], w[1])
                assert abs(g[2] - w[2]) <= 1e-6
        wgt, ggt = jap.parse_groundtruths(batch), ap_helper.parse_groundtruths(
            batch)
        assert [[c for c, _ in s] for s in ggt] == [[c for c, _ in s]
                                                     for s in wgt]
        preds = ap_helper.assemble_pred_map_cls(out["bbox_corner"], tparsed)
        for jc, tc in calcs.values():
            jc.step(preds, wgt)
            tc.step(preds, ggt)
    for t, (jc, tc) in calcs.items():
        want, got = jc.compute_metrics(), tc.compute_metrics()
        assert set(got) == set(want)
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-9, (t, k)
        assert 0 < got["mAP"] <= 1


# ------------------------------------------------------------ caption metrics
def _corpus(seed, n=40):
    rs = np.random.RandomState(seed)
    words = ("the chair is a brown wooden table near window black white "
             "tall small desk lamp sits next to under bed sofa cabinets "
             "chairs tables sitting").split()
    sent = lambda: "sos " + " ".join(rs.choice(words, rs.randint(3, 12))) \
        + " eos"
    gts = {f"scene{i:04d}|{i}|chair": [sent() for _ in range(rs.randint(1, 4))]
           for i in range(n)}
    res = {k: [sent() if rs.rand() < 0.8 else v[0]] for k, v in gts.items()}
    return gts, res


@pytest.mark.parametrize("metric", ["Bleu", "Cider", "Rouge", "Meteor"])
def test_caption_metrics_match_jax(metric):
    gts, res = _corpus(0)
    jscore, jper = getattr(jcapeval, metric)().compute_score(gts, res)
    tscore, tper = getattr(capeval, metric)().compute_score(gts, res)
    np.testing.assert_array_equal(np.asarray(tscore), np.asarray(jscore))
    np.testing.assert_array_equal(np.asarray(tper), np.asarray(jper))


def test_meteor_backend_tag_is_truthful():
    from scan2cap_torch.eval.capeval import meteor
    try:
        import nltk.stem.porter  # noqa: F401
        stemmer = True
    except ImportError:
        stemmer = False
    assert ("-stem" in meteor.METEOR_BACKEND) == stemmer
    assert meteor.Meteor.backend == meteor.METEOR_BACKEND
    # without nltk the stem stage is an identity and the tag says so
    code = ("import sys\n"
            "sys.modules['nltk'] = None\n"
            "from scan2cap_torch.eval.capeval import meteor\n"
            "assert '-stem' not in meteor.METEOR_BACKEND, meteor.METEOR_BACKEND\n"
            "assert meteor.METEOR_BACKEND.startswith('builtin-exact')\n"
            "assert meteor._stem('chairs') == 'chairs'\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT,
                   timeout=120)


# ------------------------------------------------------- the eval loop, e2e
V = 32
SMALL = dict(num_points=256, num_proposals=16, sa_npoints=(64, 32, 16, 16),
             max_num_obj=8, use_topdown=True, min_iou=-1.0, hidden_size=32,
             emb_size=16)


class _Dataset:
    """The attributes of the reference dataset that the eval loop reads."""

    def __init__(self, vocab):
        self.vocabulary = vocab
        self.emb_table = vocab["emb_table"]
        self.scanrefer = [
            {"scene_id": f"scene{i:04d}_00", "object_id": str(j),
             "ann_id": "0", "object_name": "chair",
             "token": [f"word{(3 * i + j) % 20}" for _ in range(3)]}
            for i, j in ((0, 0), (1, 1), (0, 2), (1, 3))]


def _forced(out, batch, lib):
    """Random-init detections keep nothing: every proposal becomes an
    object covering its whole scene, so the gates pass and the host code
    (the code under test) runs."""
    out = dict(out)
    pc = batch["point_clouds"][..., :3]
    if lib is torch:
        B, K = out["objectness_scores"].shape[:2]
        lo, hi = pc.amin(1), pc.amax(1)
        corners = torch.stack([torch.where(torch.tensor(m, dtype=torch.bool), hi, lo)
                               for m in ([x, y, z] for x in (0, 1)
                                         for y in (0, 1) for z in (0, 1))], 1)
        out["objectness_scores"] = torch.tensor([-5.0, 5.0]).expand(B, K, 2)
        out["bbox_corner"] = corners[:, None].expand(B, K, 8, 3)
        if "valid_masks" in out:
            out["valid_masks"] = torch.ones_like(out["valid_masks"])
        return out
    B, K = out["objectness_scores"].shape[:2]
    lo, hi = jnp.min(pc, axis=1), jnp.max(pc, axis=1)
    corners = jnp.stack([jnp.where(jnp.asarray(m), hi, lo)
                         for m in ([x, y, z] for x in (0, 1) for y in (0, 1)
                                   for z in (0, 1))], axis=1)
    out["objectness_scores"] = jnp.broadcast_to(jnp.asarray([-5.0, 5.0]),
                                                (B, K, 2))
    out["bbox_corner"] = jnp.broadcast_to(corners[:, None], (B, K, 8, 3))
    if "valid_masks" in out:
        out["valid_masks"] = jnp.ones_like(out["valid_masks"])
    return out


@pytest.fixture(scope="module", params=[4, -1], ids=["local", "full_k"])
def eval_pair(request):
    kw = dict(SMALL, num_locals=request.param)
    jcfg, cfg = JModelConfig(**kw), ModelConfig(**kw)
    vocab = synthetic.make_vocab(num_vocabs=V, emb_size=cfg.emb_size)
    batches = []
    for s in range(2):
        b = synthetic.make_scene_batch(cfg, batch_size=2, num_objects=3,
                                       vocab=vocab, seed=s)
        b["dataset_idx"] = np.array([2 * s, 2 * s + 1], np.int32)
        batches.append(b)
    jbatch = {k: jnp.asarray(v) for k, v in batches[0].items()}
    jmodel = JCapNet(jcfg, num_vocabs=V)
    state = jstep.create_train_state(Config(model=jcfg), jmodel, jbatch,
                                     jax.random.PRNGKey(0))
    jraw = jstep.make_eval_step(Config(model=jcfg), jmodel, keep_attn=True)
    model = CapNet(cfg, num_vocabs=V, device="cpu")
    model.load_state_dict(state_dict_from_flax(state.params,
                                               state.batch_stats), strict=True)
    traw = make_eval_step(cfg, model, keep_attn=True)
    ds = _Dataset(vocab)
    organized = {e["scene_id"]: {str(j): {"0": {"object_name": "chair"}}
                                 for j in range(cfg.max_num_obj)}
                 for e in ds.scanrefer}
    return dict(
        jstep=lambda st, b: _forced(jraw(st, b), b, jnp),
        tstep=lambda b: _forced(traw(b), b, torch),
        state=state, ds=ds, batches=batches, organized=organized,
        num_locals=request.param)


@pytest.mark.parametrize("use_nms", [False, True])
def test_feed_scene_cap_matches_jax(eval_pair, use_nms):
    p = eval_pair
    jint, tint = {}, {}
    want = jeh.feed_scene_cap(p["jstep"], p["state"], p["ds"], p["batches"],
                              p["organized"], min_iou=-1.0, use_nms=use_nms,
                              intermediates=jint)
    got = eval_helper.feed_scene_cap(p["tstep"], p["ds"], p["batches"],
                                     p["organized"], min_iou=-1.0,
                                     use_nms=use_nms, intermediates=tint,
                                     device="cpu")
    assert got and got == want
    assert set(tint) == set(jint)
    for scene in jint:
        assert set(tint[scene]) == set(jint[scene])
        for obj, w in jint[scene].items():
            g = tint[scene][obj]
            assert set(g) == set(w)
            assert "object_attn_weight" in g
            for k in ("object_name", "description", "token",
                      "object_attn_slots"):
                assert g[k] == w[k], k
            for k in ("box_corner", "object_attn_weight",
                      "object_attn_context"):
                np.testing.assert_allclose(np.asarray(g[k]),
                                           np.asarray(w[k]), atol=1e-4,
                                           rtol=1e-4, err_msg=k)
            if p["num_locals"] == -1:
                assert len(g["object_attn_slots"]) == SMALL["num_proposals"]
            else:
                assert len(g["object_attn_slots"]) == p["num_locals"]


def test_eval_cap_scores_match_jax(eval_pair, capsys):
    p = eval_pair
    want = jeh.eval_cap(p["jstep"], p["state"], p["ds"], p["batches"],
                        p["organized"], min_iou=-1.0)
    got = eval_helper.eval_cap(p["tstep"], p["ds"], p["batches"],
                               p["organized"], min_iou=-1.0, device="cpu")
    for (gs, gper), (ws, wper) in zip(got, want):
        np.testing.assert_allclose(np.asarray(gs), np.asarray(ws), rtol=0,
                                   atol=1e-12)
        np.testing.assert_allclose(np.asarray(gper), np.asarray(wper),
                                   rtol=0, atol=1e-12)
    assert "METEOR backend" in capsys.readouterr().out


def test_feed_scene_cap_needs_cuda_unless_told_cpu(eval_pair):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    p = eval_pair
    with pytest.raises(RuntimeError, match="device='cpu'"):
        eval_helper.feed_scene_cap(p["tstep"], p["ds"], p["batches"],
                                   p["organized"])
