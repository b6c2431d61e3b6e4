"""Caption evaluation of the pretrained (caption-only) track (counterpart of
``scan2cap_tpu/eval/eval_pretrained.py:21-66``; reference
lib/eval_helper_pretrained.py).

"gt" mode (feed_gt_cap, :105-163): a candidate for every stored box, keyed
by its stored object id (oracle boxes, no IoU gate).  "votenet" mode
(feed_votenet_cap, :163+): the stored proposals whose box overlaps the
reference box by more than ``min_iou``, through the port's bitwise
``ops.boxes.box3d_iou_batch`` on the model's device.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch

from scan2cap_torch.data.synthetic import to_device
from scan2cap_torch.device import resolve_device
from scan2cap_torch.eval.eval_helper import decode_caption, score_captions
from scan2cap_torch.ops.boxes import box3d_iou_batch
from scan2cap_torch.parallel.mesh import main_only


def feed_pretrained_cap(eval_step: Callable[[Dict], Dict], dataset, loader,
                        organized: Dict, mode: str = "gt",
                        min_iou: float = 0.5,
                        device: str | torch.device = "cuda"
                        ) -> Dict[str, List[str]]:
    """Run ``eval_step`` (a free-running decode of every box) over a loader
    of numpy batches on ``device`` and return the candidates
    {scene|object_id|object_name: [caption]}; a later box of the same
    object overwrites an earlier one."""
    device = resolve_device(device)
    candidates: Dict[str, List[str]] = {}
    idx2word = dataset.vocabulary["idx2word"]
    emb_table = torch.as_tensor(np.asarray(dataset.emb_table)).to(device)
    for batch in loader:
        tbatch = to_device({k: v for k, v in batch.items()
                            if k != "glove_emb_table"}, device)
        tbatch["glove_emb_table"] = emb_table
        out = eval_step(tbatch)
        caps = out["lang_cap"].cpu().numpy()                # (B, K, T)
        keep = tbatch["bbox_mask"] == 1
        if mode == "votenet":
            keep &= box3d_iou_batch(tbatch["bbox_corner"],
                                    tbatch["ref_box_corner_label"][:, None]
                                    ) > min_iou
        keep = keep.cpu().numpy()
        obj_ids = np.asarray(batch["scene_object_ids"])
        for b in range(caps.shape[0]):
            scene_id = dataset.scanrefer[
                int(batch["dataset_idx"][b])]["scene_id"]
            for k in np.where(keep[b])[0]:
                object_id = str(int(obj_ids[b, k]))
                try:
                    ann_list = list(organized[scene_id][object_id].keys())
                    object_name = organized[scene_id][object_id][
                        ann_list[0]]["object_name"]
                except KeyError:
                    continue
                key = f"{scene_id}|{object_id}|{object_name}"
                candidates[key] = [decode_caption(caps[b, k], idx2word)]
    return candidates


def eval_pretrained_cap(eval_step, dataset, loader, organized, corpus,
                        mode: str = "gt", min_iou: float = 0.5,
                        use_meteor_jar: bool = False,
                        device: str | torch.device = "cuda"):
    """(bleu, cider, rouge, meteor) of the candidates against ``corpus``."""
    candidates = feed_pretrained_cap(eval_step, dataset, loader, organized,
                                     mode, min_iou, device)
    # under a mesh rank 0 scores and hands the scores to every rank
    return main_only(score_captions, corpus, candidates, use_meteor_jar)
