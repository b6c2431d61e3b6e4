"""Vote2Cap-DETR: 3DETR-m's masked encoder and set-prediction decoder with
vote queries and a GPT-2 caption head, trained on every GT object's
description."""

from __future__ import annotations

from typing import Dict, List

import torch

from h100bench import flops_vote2cap, scenes
from h100bench.reference import vote2cap

# inputs that the whole batch shares, not cut with its scenes
SHARED = ()
count = flops_vote2cap.count
KEYS = ("center_label", "size_class_label", "size_residual_label",
        "sem_cls_label", "box_label_mask", "vote_label", "vote_label_mask")


def batches(seed: int, cfg: Dict, traffic: Dict, device
            ) -> List[Dict[str, torch.Tensor]]:
    """The pool: ``scenes.rooms`` of ``described_objects`` boxes a scene
    (the configuration's, which ``flops_vote2cap.count`` reads too) with
    colour (uniform in [-0.5, 0.5]) and normal (N(0, 0.01)) columns, and
    one seeded description of 3 to ``max_des_len`` words per GT object
    (SOS, words, EOS, padding)."""
    g = torch.Generator(device=device).manual_seed(seed)
    S = traffic["pool"] * traffic["batch"]
    O, M = cfg["described_objects"], cfg["max_num_obj"]
    r = scenes.rooms(g, S, cfg, O, M, None, device)
    xyz = r["xyz"]
    cols = [xyz]
    if cfg["use_color"]:
        cols.append(scenes.uniform(g, xyz.shape, -0.5, 0.5, device))
    if cfg["use_normal"]:
        cols.append(torch.randn(xyz.shape, generator=g, device=device) * 0.1)
    T = cfg["max_des_len"] + 2
    words = torch.randint(3, cfg["max_des_len"] + 1, (S, M), generator=g,
                          device=device)
    length = words + 2
    slot = torch.arange(T, device=device)
    ids = torch.randint(scenes.FIRST_WORD, cfg["num_vocabs"], (S, M, T),
                        generator=g, device=device)
    ids = torch.where(slot == 0, scenes.SOS, ids)
    ids = torch.where(slot == length[..., None] - 1, scenes.EOS, ids)
    ids = torch.where(slot >= length[..., None], 0, ids)
    ids = torch.where(r["box_label_mask"][..., None] > 0, ids, 0)
    pool = {k: r[k] for k in KEYS}
    pool["point_clouds"] = torch.cat(cols, -1)
    pool["object_lang_ids"] = ids.to(torch.int32)
    return scenes.split(pool, traffic["pool"], traffic["batch"])


def reference(cfg):
    return vote2cap.Vote2Cap(cfg)


def reference_loss(ref, batch, momentum):
    return vote2cap.loss(ref(batch, True, momentum), ref.cfg)


def program(mcfg, cfg, device):
    from scan2cap_torch.config import Vote2CapConfig
    from scan2cap_torch.models.vote2cap import Vote2CapDETR
    return Vote2CapDETR(mcfg, Vote2CapConfig.from_dict(cfg), device=device)


def train_step(mcfg, state, traffic):
    from scan2cap_torch.train.step import make_vote2cap_step
    return make_vote2cap_step(mcfg, state)
