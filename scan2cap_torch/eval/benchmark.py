"""Offline benchmark scorer (counterpart of ``scan2cap_tpu/eval/benchmark.py``;
reference benchmark/eval.py, eval_densecap.py, densecap_helper.py).

File formats are the reference's:
  * ``pred.json`` (benchmark/predict.py:207-233): {scene_id: [{"caption":
    "sos ... eos", "box": (8, 3) list, "sem_prob": (18,), "obj_prob": (2,)}]}
  * GT: the ScanRefer entries with a "bbox" (8, 3) corner list
    (``scripts.build_benchmark_gt``), organised per scene as {"captions",
    "boxes", "object_ids", "object_sems"} (benchmark/eval.py:100-178).

Evaluation (benchmark/eval.py:180-501):
  * Hungarian assignment of predictions to GT boxes over -gIoU, its cost
    on ``device``: float64 for axis-aligned boxes (ScanNet's,
    benchmark/eval.py:186-192), float32 for the z-rotated polygon clip;
  * caption metrics at IoU {0, 0.25, 0.5} as precision (/ predictions),
    recall (/ GT boxes) and F1;
  * detection mAP at 0.25 and 0.5, with class-aware NMS on ``device``;
  * dense-caption mAP over the (IoU x METEOR) grid [.1-.5] x [.15-.75], and
    where the sentence METEOR is not the reference's (nltk with WordNet),
    also over the grid calibrated to the offline scorer.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment

from scan2cap_torch.config import SCANNET_TYPE2CLASS
from scan2cap_torch.device import resolve_device
from scan2cap_torch.eval.ap_helper import (APCalculator, _aabb_iou_1_to_many,
                                           voc_ap)
from scan2cap_torch.eval.capeval import Bleu, Cider, Meteor, Rouge
from scan2cap_torch.eval.capeval.meteor import METEOR_BACKEND
from scan2cap_torch.eval.capeval.meteor import (
    single_meteor_score as _builtin_meteor)
from scan2cap_torch.ops.boxes import (generalized_box3d_iou_aabb,
                                      generalized_box3d_iou_rotated)
from scan2cap_torch.ops.nms import nms_3d


def _pick_sentence_meteor():
    """The reference's dense-caption path scores with
    nltk.translate.meteor_score (benchmark/eval_densecap.py:26), whose
    synonym stage needs the WordNet corpus: used where it is installed,
    else the built-in scorer, tagged with the stages it really runs
    (``capeval.meteor.METEOR_BACKEND``)."""
    try:
        from nltk.translate.meteor_score import single_meteor_score as nm
        nm("a b".split(), "a c".split())        # probes the WordNet lookup
        return (lambda ref, hyp: nm(ref.split(), hyp.split())), "nltk-wordnet"
    except Exception:           # no nltk, or no WordNet corpus
        return _builtin_meteor, METEOR_BACKEND


# Which sentence METEOR scores the dense captions is part of the result:
# the absolute .15-.75 thresholds are calibrated to the full (WordNet)
# scorer, so only runs with the same backend compare.  Every densecap
# result records it.
single_meteor_score, SENTENCE_METEOR_BACKEND = _pick_sentence_meteor()


# ---------------------------------------------------------------------------
# organisation (benchmark/eval.py:100-178)
# ---------------------------------------------------------------------------

def organize_prediction(predictions: Dict) -> Dict:
    organized = {}
    for scene_id, data in predictions.items():
        organized[scene_id] = {
            "captions": [p["caption"] for p in data],
            "boxes": np.asarray([p["box"] for p in data], np.float64),
            "sem_prob": np.asarray([p["sem_prob"] for p in data], np.float64),
            "obj_prob": np.asarray([p["obj_prob"] for p in data], np.float64),
        }
    return organized


def _sem_id(object_name: str) -> int:
    return SCANNET_TYPE2CLASS.get(" ".join(object_name.split("_")), 17)


def organize_gt(gt_json) -> Dict:
    """The GT json: a LIST of ScanRefer entries each with a "bbox" (8, 3)
    corner list (``scripts.build_benchmark_gt``), grouped per scene: one box
    per object, every annotation's caption (benchmark/eval.py:100-178).  A
    {scene: {"boxes": ...}} dict passes through; a nested {scene:
    {object_id: [annotations]}} dict is flattened first."""
    if isinstance(gt_json, dict):
        first = next(iter(gt_json.values()), None)
        if isinstance(first, dict) and "boxes" in first:
            return gt_json
        gt_json = [dict(a, scene_id=s, object_id=o)
                   for s, objs in gt_json.items()
                   for o, anns in objs.items() for a in anns]
    by_scene: Dict[str, Dict[str, list]] = {}
    for d in gt_json:
        by_scene.setdefault(d["scene_id"], {}) \
            .setdefault(d["object_id"], []).append(d)
    organized = {}
    for scene_id, objects in by_scene.items():
        boxes, object_ids, object_sems, captions = [], [], [], []
        for object_id, anns in objects.items():
            boxes.append(np.asarray(anns[0]["bbox"], np.float64))
            object_ids.append(int(object_id))
            object_sems.append(anns[0].get(
                "sem_id", _sem_id(anns[0].get("object_name", ""))))
            captions.append(["sos " + " ".join(a["token"]) + " eos"
                             for a in anns])
        organized[scene_id] = {
            "captions": captions,
            "boxes": np.asarray(boxes),
            "object_ids": np.asarray(object_ids),
            "object_sems": np.asarray(object_sems),
        }
    return organized


def prepare_corpus(gts: Dict) -> Dict:
    corpus = {}
    for scene_id, value in gts.items():
        for gt_id, object_id in enumerate(value["object_ids"]):
            corpus[f"{scene_id}|{object_id}"] = value["captions"][gt_id]
    return corpus


# ---------------------------------------------------------------------------
# assignment (benchmark/eval.py:180-290)
# ---------------------------------------------------------------------------

def _iou_aabb_pairwise(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    """(N, 8, 3) x (N, 8, 3) elementwise IoU."""
    lo1, hi1 = boxes1.min(1), boxes1.max(1)
    lo2, hi2 = boxes2.min(1), boxes2.max(1)
    inter = np.prod(np.maximum(np.minimum(hi1, hi2) - np.maximum(lo1, lo2), 0),
                    -1)
    v1 = np.prod(hi1 - lo1, -1)
    v2 = np.prod(hi2 - lo2, -1)
    return inter / (v1 + v2 - inter + 1e-8)


def assign_pred_to_gt(predictions: Dict, gts: Dict,
                      rotated_boxes: bool = False,
                      device: str | torch.device = "cuda"):
    """Hungarian gIoU assignment per scene, then the best candidate per GT
    box (benchmark/eval.py:239-290).  ``rotated_boxes`` takes the cost from
    the z-rotated polygon clip on ``device`` (the reference's
    rotated_boxes=True path); ScanNet's boxes are axis-aligned, so the
    default matches its evaluation."""
    dev = resolve_device(device)
    candidates = {}
    total_num_preds, total_num_gts = 0, 0
    for scene_id in gts:
        if scene_id not in predictions:
            continue
        preds = predictions[scene_id]
        gt = gts[scene_id]
        pred_boxes = preds["boxes"]
        gt_boxes = gt["boxes"]
        total_num_preds += len(pred_boxes)
        total_num_gts += len(gt_boxes)
        if len(pred_boxes) == 0 or len(gt_boxes) == 0:
            continue

        if rotated_boxes:
            cost = -generalized_box3d_iou_rotated(
                torch.as_tensor(pred_boxes, dtype=torch.float32).to(dev),
                torch.as_tensor(gt_boxes, dtype=torch.float32).to(dev)
            ).cpu().numpy()
        else:
            # the axis-aligned extents in float64, as the reference's
            # numpy scorer (benchmark/box_util.py:634-696)
            cost = -generalized_box3d_iou_aabb(
                torch.as_tensor(pred_boxes, dtype=torch.float64).to(dev),
                torch.as_tensor(gt_boxes, dtype=torch.float64).to(dev)
            ).cpu().numpy()
        row, col = linear_sum_assignment(cost)
        per_gt_prop = np.zeros(len(gt_boxes), np.int64)
        per_gt_prop[col] = row

        matched = pred_boxes[per_gt_prop]                  # (ngt, 8, 3)
        ious = _iou_aabb_pairwise(matched, gt_boxes)
        for gt_id in range(len(gt_boxes)):
            key = f"{scene_id}|{gt['object_ids'][gt_id]}"
            entry = {
                "caption": preds["captions"][per_gt_prop[gt_id]],
                "iou": float(ious[gt_id]),
                "box": matched[gt_id].tolist(),
                "gt_box": gt_boxes[gt_id].tolist(),
            }
            if key not in candidates or entry["iou"] > candidates[key]["iou"]:
                candidates[key] = entry
    return candidates, total_num_preds, total_num_gts


def filter_candidates(candidates: Dict, min_iou: float):
    masks, new = [], {}
    for key, value in candidates.items():
        masks.append(1 if value["iou"] >= min_iou else 0)
        new[key] = [value["caption"]]
    return np.asarray(masks), new


# ---------------------------------------------------------------------------
# captioning metrics with precision, recall and F1 (benchmark/eval.py:303-378)
# ---------------------------------------------------------------------------

def evaluate_captioning(predictions: Dict, gts: Dict,
                        min_ious: Sequence[float] = (0, 0.25, 0.5),
                        verbose: bool = False, rotated_boxes: bool = False,
                        device: str | torch.device = "cuda") -> Dict:
    assigned, n_preds, n_gts = assign_pred_to_gt(predictions, gts,
                                                 rotated_boxes, device)
    corpus = prepare_corpus(gts)

    results = {}
    for min_iou in min_ious:
        _, candidates = filter_candidates(assigned, min_iou)
        for key in corpus:
            if key not in candidates:
                candidates[key] = ["sos eos"]
        ordered = {k: candidates[k] for k in corpus}
        # per key: 1 iff the assigned prediction clears the IoU gate
        key_mask = np.asarray(
            [1 if (k in assigned and assigned[k]["iou"] >= min_iou) else 0
             for k in ordered])

        bleu = Bleu(4).compute_score(corpus, ordered)
        cider = Cider().compute_score(corpus, ordered)
        rouge = Rouge().compute_score(corpus, ordered)
        meteor = Meteor().compute_score(corpus, ordered)

        res = {"precision": {}, "recall": {}, "f1-score": {}}
        per = {
            "bleu": [np.asarray(bleu[1][k]) for k in range(4)],
            "cider": np.asarray(cider[1]),
            "rouge": np.asarray(rouge[1]),
            "meteor": np.asarray(meteor[1]),
        }
        for name, scores in per.items():
            if name == "bleu":
                p = [float(np.sum(s * key_mask) / max(n_preds, 1))
                     for s in scores]
                r = [float(np.sum(s * key_mask) / max(n_gts, 1))
                     for s in scores]
                f = [2 * a * b / (a + b) if (a + b) > 0 else 0.0
                     for a, b in zip(p, r)]
            else:
                p = float(np.sum(scores * key_mask) / max(n_preds, 1))
                r = float(np.sum(scores * key_mask) / max(n_gts, 1))
                f = 2 * p * r / (p + r) if (p + r) > 0 else 0.0
            res["precision"][name] = p
            res["recall"][name] = r
            res["f1-score"][name] = f
        results[min_iou] = res
        if verbose:
            print(f"--- captioning @ IoU {min_iou}: "
                  f"C-F1 {res['f1-score']['cider']:.4f} "
                  f"B4-F1 {res['f1-score']['bleu'][3]:.4f} "
                  f"M-F1 {res['f1-score']['meteor']:.4f} "
                  f"R-F1 {res['f1-score']['rouge']:.4f}")
    return results


# ---------------------------------------------------------------------------
# detection mAP from stored predictions (benchmark/eval.py:423-470)
# ---------------------------------------------------------------------------

def evaluate_detection(predictions: Dict, gts: Dict, verbose: bool = False,
                       device: str | torch.device = "cuda") -> Dict:
    dev = resolve_device(device)
    calcs = {t: APCalculator(t) for t in (0.25, 0.5)}
    for scene_id in gts:
        if scene_id not in predictions:
            continue
        preds = predictions[scene_id]
        boxes = preds["boxes"]                              # (M, 8, 3)
        gt_list = [(int(gts[scene_id]["object_sems"][i]),
                    gts[scene_id]["boxes"][i])
                   for i in range(len(gts[scene_id]["boxes"]))]
        if len(boxes) == 0:        # a scene can survive NMS with no boxes
            for c in calcs.values():
                c.step([[]], [gt_list])
            continue
        obj_prob = preds["obj_prob"][:, 1]
        sem_prob = preds["sem_prob"]
        cls = sem_prob.argmax(-1)
        keep = nms_3d(
            torch.as_tensor(boxes[None], dtype=torch.float32).to(dev),
            torch.as_tensor(obj_prob[None], dtype=torch.float32).to(dev),
            torch.as_tensor(cls[None]).to(dev), 0.25, True).cpu().numpy()[0]
        cur = []
        for c in range(sem_prob.shape[1]):
            cur += [(c, boxes[j], float(sem_prob[j, c] * obj_prob[j]))
                    for j in range(len(boxes))
                    if keep[j] and obj_prob[j] > 0.05]
        for c in calcs.values():
            c.step([cur], [gt_list])
    out = {}
    for t, c in calcs.items():
        m = c.compute_metrics()
        out[t] = m
        if verbose:
            print(f"--- detection mAP@{t}: {m['mAP']:.4f} AR@{t}: {m['AR']:.4f}")
    return out


# ---------------------------------------------------------------------------
# dense-captioning mAP (densecap_helper.py, eval_densecap.py)
# ---------------------------------------------------------------------------

def eval_densecap(pred: Dict, gt: Dict, thresholds=(0.25, 0.25), cache=None):
    """PR and AP at one (IoU, METEOR) threshold pair (eval_densecap.py:81-205).
    ``cache`` holds each detection's IoUs and METEORs against its scene's GT
    boxes, which no threshold changes; None builds it."""
    class_recs = {}
    npos = 0
    for img_id, items in gt.items():
        class_recs[img_id] = {
            "bbox": np.asarray([v[0] for v in items]),
            "caption": [v[1] for v in items],
            "det": [False] * len(items),
        }
        npos += len(items)
    for img_id in pred:
        if img_id not in class_recs:
            class_recs[img_id] = {"bbox": np.array([]), "caption": [],
                                  "det": []}

    image_ids, confidence, BB, CAP = [], [], [], []
    for img_id, dets in pred.items():
        for box, score, caption in dets:
            image_ids.append(img_id)
            confidence.append(score)
            BB.append(box)
            CAP.append(caption)
    if not image_ids:
        return np.zeros(0), np.zeros(0), 0.0, ([], [])
    order = np.argsort(-np.asarray(confidence))
    BB = np.asarray(BB)[order]
    CAP = [CAP[i] for i in order]
    image_ids = [image_ids[i] for i in order]

    iou_cache, meteor_cache = cache if cache is not None else ([], [])
    fill_cache = cache is None

    nd = len(image_ids)
    tp = np.zeros(nd)
    fp = np.zeros(nd)
    for d in range(nd):
        R = class_recs[image_ids[d]]
        gt_boxes = R["bbox"]
        if fill_cache:
            if gt_boxes.size > 0:
                ious = _aabb_iou_1_to_many(BB[d].astype(float),
                                           gt_boxes.astype(float))
                meteors = np.asarray([
                    max(single_meteor_score(ref, CAP[d]) for ref in refs)
                    if refs else 0.0 for refs in R["caption"]])
            else:
                ious, meteors = np.zeros(0), np.zeros(0)
            iou_cache.append(ious)
            meteor_cache.append(meteors)
        ious, meteors = iou_cache[d], meteor_cache[d]

        ovmax, nlpmax, jmax = -np.inf, -np.inf, -1
        for j in range(len(ious)):  # joint argmax (eval_densecap.py:167-171)
            if ious[j] > ovmax and meteors[j] > nlpmax:
                ovmax, nlpmax, jmax = ious[j], meteors[j], j

        if ovmax > thresholds[0] and nlpmax > thresholds[1] \
                and not R["det"][jmax]:
            tp[d] = 1.0
            R["det"][jmax] = True
        else:
            fp[d] = 1.0

    fp = np.cumsum(fp)
    tp = np.cumsum(tp)
    rec = tp / float(npos + 1e-8)
    prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    return rec, prec, voc_ap(rec, prec), (iou_cache, meteor_cache)


class DenseCapAPCalculator:
    """AP over the (IoU x METEOR) grid (densecap_helper.py:92-160)."""

    def __init__(self, iou_thresholds=(.1, .2, .3, .4, .5),
                 meteor_thresholds=(.15, .3, .45, .6, .75)):
        self.thresholds = [(i, m) for i in iou_thresholds
                           for m in meteor_thresholds]
        self.reset()

    def step(self, batch_pred, batch_gt):
        for p, g in zip(batch_pred, batch_gt):
            self.pred_map[self.scan_cnt] = p
            self.gt_map[self.scan_cnt] = g
            self.scan_cnt += 1

    def compute_metrics(self, cache=None) -> Dict:
        # the per-detection (ious, meteors) cache does not depend on the
        # thresholds: one build serves every cell of the grid, and through
        # ``cache`` a second calculator over the same maps (the calibrated
        # grid)
        aps = []
        ap_dict: Dict = {}
        for iou, meteor in self.thresholds:
            _, _, ap, cache = eval_densecap(
                self.pred_map, self.gt_map, (iou, meteor), cache)
            aps.append(ap)
            ap_dict.setdefault(iou, {})[meteor] = ap
        self.cache = cache
        return {"AP": ap_dict, "mAP": float(np.mean(aps))}

    def reset(self):
        self.pred_map = {}
        self.gt_map = {}
        self.scan_cnt = 0
        self.cache = None


def evaluate_dense_captioning(predictions: Dict, gts: Dict,
                              verbose: bool = False) -> Dict:
    calc = DenseCapAPCalculator()
    for scene_id in gts:
        if scene_id not in predictions:
            continue
        preds = predictions[scene_id]
        gt_list = [(gts[scene_id]["boxes"][j], gts[scene_id]["captions"][j])
                   for j in range(len(gts[scene_id]["boxes"]))]
        if len(preds["boxes"]) == 0:
            calc.step([[]], [gt_list])
            continue
        obj_prob = preds["obj_prob"][:, 1]
        pred_list = [(preds["boxes"][j], float(obj_prob[j]),
                      preds["captions"][j]) for j in range(len(preds["boxes"]))]
        calc.step([pred_list], [gt_list])
    results = calc.compute_metrics()
    results["meteor_backend"] = SENTENCE_METEOR_BACKEND
    if verbose:
        print(f"--- dense captioning mAP (raw, reference thresholds): "
              f"{results['mAP']:.4f} "
              f"(sentence-METEOR backend: {SENTENCE_METEOR_BACKEND})")
    # The offline scorer runs below the full METEOR the [.15-.75]
    # thresholds were set on, so the raw grid gates too hard; the
    # calibrated grid lowers each threshold by the shortfall fitted on the
    # delta corpus against its synonym oracle (an upper bound), so the
    # reference-equivalent mAP lies between the two.  Both are labelled
    # (capeval/calibration.py).
    if SENTENCE_METEOR_BACKEND != "nltk-wordnet":
        from scan2cap_torch.eval.capeval.calibration import (
            calibrated_meteor_thresholds)
        cal_ths, fit = calibrated_meteor_thresholds()
        cal_calc = DenseCapAPCalculator(meteor_thresholds=cal_ths)
        cal_calc.pred_map = calc.pred_map
        cal_calc.gt_map = calc.gt_map
        cal_calc.scan_cnt = calc.scan_cnt
        cal = cal_calc.compute_metrics(cache=calc.cache)
        results["calibrated"] = {
            "AP": cal["AP"], "mAP": cal["mAP"],
            "meteor_thresholds": list(cal_ths),
            "reference_thresholds": [.15, .3, .45, .6, .75],
            "fit": fit,
            "note": "thresholds lowered by the offline-backend METEOR "
                    "shortfall fitted on the delta corpus vs its synonym "
                    "oracle; brackets the reference-backend grid from above",
        }
        if verbose:
            print(f"--- dense captioning mAP (backend-calibrated "
                  f"thresholds {list(cal_ths)}): {cal['mAP']:.4f} "
                  f"(shortfall fit a={fit['a']:.4f} b={fit['b']:.4f} "
                  f"on {fit['n_pairs']} pairs)")
    return results


def evaluate(predictions_raw: Dict, gt_json, verbose: bool = True,
             caption: bool = True, detection: bool = True,
             densecap: bool = True, rotated_boxes: bool = False,
             device: str | torch.device = "cuda") -> Dict:
    """The whole offline evaluation (benchmark/eval.py:472-501); the
    rotated assignment and NMS run on ``device``."""
    predictions = organize_prediction(predictions_raw)
    gts = organize_gt(gt_json)
    out = {}
    if caption:
        out["captioning"] = evaluate_captioning(
            predictions, gts, verbose=verbose, rotated_boxes=rotated_boxes,
            device=device)
    if detection:
        out["detection"] = evaluate_detection(predictions, gts,
                                              verbose=verbose, device=device)
    if densecap:
        out["densecap"] = evaluate_dense_captioning(predictions, gts,
                                                    verbose=verbose)
    return out
