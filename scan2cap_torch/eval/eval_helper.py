"""Caption evaluation gated by the detections (counterpart of
``scan2cap_tpu/eval/eval_helper.py``; reference lib/eval_helper.py).

Device/host split: per batch the model's device runs the eval forward and
the post-processing (``postprocess_scene_cap``: NMS and objectness mask,
the assigned GT object id per proposal, the IoU gate); the host decodes
token ids to strings, fills the candidates dict and scores the corpus.

Semantics preserved:
  * POST processing: 3D class-NMS at IoU 0.25, remove_empty_box (>=5 points
    inside the axis-aligned box), conf 0.05 (eval_helper.py:179-191);
  * final mask = NMS and objectness-argmax (eval_helper.py:193-199);
  * per-proposal GT assignment from the detection loss (object_assignment),
    caption kept if IoU(pred, assigned GT) > min_iou = 0.5
    (eval_helper.py:201-219);
  * candidates keyed "scene|object_id|object_name"; later proposals for the
    same object overwrite earlier ones; missing keys filled with "sos eos"
    (check_candidates, eval_helper.py:69-79).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from scan2cap_torch.data.synthetic import to_device
from scan2cap_torch.device import resolve_device
from scan2cap_torch.eval.ap_helper import nonempty_boxes
from scan2cap_torch.eval.capeval import Bleu, Cider, Meteor, Rouge
from scan2cap_torch.ops.boxes import box3d_iou_batch
from scan2cap_torch.ops.nms import nms_3d
from scan2cap_torch.parallel.mesh import main_only


def prepare_corpus(raw_data: Sequence[dict], max_len: int = 30) -> Dict:
    """GT corpus {scene|object_id|object_name: ["sos ... eos", ...]}
    (eval_helper.py:33-54)."""
    corpus: Dict[str, List[str]] = {}
    for data in raw_data:
        key = "{}|{}|{}".format(
            data["scene_id"], data["object_id"], data["object_name"])
        description = "sos " + " ".join(data["token"][:max_len]) + " eos"
        corpus.setdefault(key, []).append(description)
    return corpus


def decode_caption(token_ids: np.ndarray, idx2word: Dict) -> str:
    """Token ids -> "sos w1 w2 ... eos" (eval_helper.py:56-67)."""
    decoded = ["sos"]
    for t in np.asarray(token_ids).tolist():
        word = idx2word[str(int(t))]
        decoded.append(word)
        if word == "eos":
            break
    if "eos" not in decoded:
        decoded.append("eos")
    return " ".join(decoded)


def check_candidates(corpus: Dict, candidates: Dict) -> Dict:
    for key in corpus:
        if key not in candidates:
            candidates[key] = ["sos eos"]
    return candidates


def organize_candidates(corpus: Dict, candidates: Dict) -> Dict:
    return {k: candidates[k] for k in corpus}


def postprocess_scene_cap(out: Dict, batch: Dict, min_iou: float = 0.5,
                          nms_iou: float = 0.25,
                          use_nms: bool = True) -> Dict:
    """Post-processing for caption eval on the model's device: ``out`` is
    the eval step's result, ``batch`` its input (``point_clouds``,
    ``scene_object_ids``, ``gt_box_corner_label``).  Returns ``keep`` (B, K)
    bool, ``detected_object_ids`` (B, K) int32, ``ious`` (B, K) and the
    ``captions`` (B, K, T) token ids, and the gates that ``keep`` is made
    of, each (B, K) bool: ``nonempty``, ``nms_mask`` (NMS and nonempty) and
    ``final_mask`` (also objectness).  The NMS syncs with the host once."""
    corners = out["bbox_corner"]                       # (B, K, 8, 3)
    obj_prob = torch.softmax(out["objectness_scores"], dim=-1)[..., 1]
    pred_cls = torch.argmax(out["sem_cls_scores"], dim=-1)
    nonempty = nonempty_boxes(corners, batch["point_clouds"])
    if use_nms:
        nms_mask = nms_3d(corners, torch.where(nonempty, obj_prob, -1.0),
                          pred_cls, iou_threshold=nms_iou, same_cls=True)
        nms_mask = nms_mask & nonempty
    else:  # --no_nms (scripts/eval.py:253): objectness/empty filters only
        nms_mask = nonempty
    obj_mask = torch.argmax(out["objectness_scores"], dim=-1) == 1
    final_mask = nms_mask & obj_mask                   # (B, K)

    assignment = out["object_assignment"].long()       # (B, K)
    detected_object_ids = torch.gather(
        batch["scene_object_ids"].to(torch.int32), 1, assignment)
    assigned_corners = torch.gather(
        batch["gt_box_corner_label"], 1,
        assignment[:, :, None, None].expand(-1, -1, 8, 3))  # (B, K, 8, 3)
    ious = box3d_iou_batch(assigned_corners, corners)  # (B, K)
    return {
        "keep": final_mask & (ious > min_iou),
        "detected_object_ids": detected_object_ids,
        "ious": ious,
        "captions": out["lang_cap"],
        "nonempty": nonempty,
        "nms_mask": nms_mask,
        "final_mask": final_mask,
    }


def feed_scene_cap(
    eval_step: Callable[[Dict], Dict],
    dataset,
    loader,
    organized: Dict,
    min_iou: float = 0.5,
    use_nms: bool = True,
    intermediates: Optional[Dict] = None,
    device: str | torch.device = "cuda",
) -> Dict:
    """Run eval over a loader of numpy batches and return the candidates
    dict.  ``eval_step(batch) -> out`` is ``train.step.make_eval_step``'s
    function; each batch goes to ``device`` (the model's) and the
    vocabulary's embedding table is uploaded once.

    ``intermediates``: pass a dict to also collect the reference's
    --save_interm dump (eval_helper.py:242-268) per kept object:
    object_name, box corners, decoded caption + tokens, and (when the
    decoder emitted them, ``make_eval_step(keep_attn=True)``) the per-step
    attention weights with their proposal ids and box corners: over the
    local context slots (copied in bulk), or, from the full-K decode, over
    the kept proposal's valid context proposals (copied per kept
    proposal)."""
    device = resolve_device(device)
    candidates: Dict[str, List[str]] = {}
    idx2word = dataset.vocabulary["idx2word"]
    emb_table = torch.as_tensor(np.asarray(dataset.emb_table)).to(device)
    for batch in loader:
        tbatch = to_device({k: v for k, v in batch.items()
                            if k != "glove_emb_table"}, device)
        tbatch["glove_emb_table"] = emb_table
        out = eval_step(tbatch)
        post = postprocess_scene_cap(out, tbatch, min_iou=min_iou,
                                     use_nms=use_nms)
        keep = post["keep"].cpu().numpy()
        det_ids = post["detected_object_ids"].cpu().numpy()
        caps = post["captions"].cpu().numpy()
        ds_idx = np.asarray(batch["dataset_idx"])
        if intermediates is not None:
            corners = out["bbox_corner"].cpu().numpy()
            # local-slot decode: (B, K, T, L) is small, copied in bulk;
            # full-K decode: (B, K, T, K) stays on the device and each kept
            # proposal's slice is copied below
            slots = (out["topdown_attn_slots"].cpu().numpy()
                     if "topdown_attn_slots" in out else None)
            attn_dev = out.get("topdown_attn")
            attn = (attn_dev.cpu().numpy()
                    if attn_dev is not None and slots is not None else None)
            valid_all = (out["valid_masks"].cpu().numpy()
                         if attn_dev is not None and slots is None else None)
        for b in range(keep.shape[0]):
            scene_id = dataset.scanrefer[int(ds_idx[b])]["scene_id"]
            for k in np.where(keep[b])[0]:
                object_id = str(int(det_ids[b, k]))
                try:
                    ann_list = list(organized[scene_id][object_id].keys())
                    object_name = organized[scene_id][object_id][
                        ann_list[0]]["object_name"]
                except KeyError:
                    continue
                key = f"{scene_id}|{object_id}|{object_name}"
                caption = decode_caption(caps[b, k], idx2word)
                candidates[key] = [caption]
                if intermediates is not None:
                    entry = intermediates.setdefault(
                        scene_id, {}).setdefault(object_id, {})
                    entry["object_name"] = object_name
                    entry["box_corner"] = corners[b, k].tolist()
                    entry["description"] = caption
                    entry["token"] = caption.split(" ")
                    if attn is not None and slots is not None:
                        sl = slots[b, k]
                        entry["object_attn_weight"] = attn[b, k].tolist()
                        entry["object_attn_slots"] = sl.tolist()
                        entry["object_attn_context"] = \
                            corners[b, sl].tolist()
                    elif attn_dev is not None:
                        # full-K attention: keep only the VALID context
                        # proposals (the reference's valid_context_masks
                        # gate, eval_helper.py:254-260)
                        sl = np.where(valid_all[b, k] == 1)[0]
                        w = attn_dev[b, k].cpu().numpy()    # (T, K) slice
                        entry["object_attn_weight"] = w[:, sl].tolist()
                        entry["object_attn_slots"] = sl.tolist()
                        entry["object_attn_context"] = \
                            corners[b, sl].tolist()
    return candidates


def score_captions(corpus: Dict, candidates: Dict,
                   use_meteor_jar: bool = False):
    """Corpus metrics (eval_helper.py:457-480). Returns
    (bleu, cider, rouge, meteor) each as (score, per-key scores)."""
    candidates = check_candidates(corpus, candidates)
    candidates = organize_candidates(corpus, candidates)
    bleu = Bleu(4).compute_score(corpus, candidates)
    cider = Cider().compute_score(corpus, candidates)
    rouge = Rouge().compute_score(corpus, candidates)
    if use_meteor_jar:
        from scan2cap_torch.eval.capeval.meteor import MeteorJava
        scorer = MeteorJava()
    else:
        scorer = Meteor()
    meteor = scorer.compute_score(corpus, candidates)
    # which matcher stages scored METEOR is part of the result — absolute
    # values are only comparable across runs with the same backend
    print(f"[score_captions] METEOR backend: {scorer.backend}")
    return bleu, cider, rouge, meteor


def eval_cap(
    eval_step: Callable[[Dict], Dict],
    dataset,
    loader,
    organized: Dict,
    min_iou: float = 0.5,
    corpus: Optional[Dict] = None,
    use_meteor_jar: bool = False,
    use_nms: bool = True,
    intermediates: Optional[Dict] = None,
    device: str | torch.device = "cuda",
):
    """Full caption evaluation (eval_helper.py:388-512):
    corpus prep -> model feed -> metric scoring.  Under a mesh every rank
    feeds (``eval_step`` wrapped by ``parallel.mesh.mesh_eval_fn``) and
    rank 0 scores, handing the scores to every rank."""
    if corpus is None:
        corpus = prepare_corpus(dataset.scanrefer_full
                                if hasattr(dataset, "scanrefer_full")
                                else dataset.scanrefer)
    candidates = feed_scene_cap(
        eval_step, dataset, loader, organized, min_iou, use_nms=use_nms,
        intermediates=intermediates, device=device)
    return main_only(score_captions, corpus, candidates, use_meteor_jar)
