"""Caption-only CapNet over stored box features
(counterpart of ``scan2cap_tpu/models/capnet_pretrained.py:34-77``;
reference models/capnet_pretrained.py).

An optional graph over the stored boxes, then the caption head.  "gt" mode
reads 128 GT boxes and takes the caption's target from the batch's
``bbox_idx`` (the top-down decoder's oracle); "votenet" mode reads 256
stored VoteNet proposals and picks the target by IoU with the reference box,
as the scene path does.  Module names follow the Flax tree (``graph``,
``caption``), so ``convert.state_dict_from_flax`` carries JAX weights.
"""

from __future__ import annotations

import torch
from torch import nn

from scan2cap_torch.config import ModelConfig
from scan2cap_torch.device import resolve_device
from scan2cap_torch.models.caption import (SceneCaptionModule,
                                           TopDownSceneCaptionModule)
from scan2cap_torch.models.graph import GraphModule
from scan2cap_torch.models.layers import seeded_init

MODES = {"gt": 128, "votenet": 256}          # mode -> boxes per sample
FEAT_SIZE = 128


class CapNetPretrained(nn.Module):
    def __init__(self, cfg: ModelConfig, mode: str = "gt",
                 num_vocabs: int = 4, num_vocabs_padded: int = 0,
                 device: str | torch.device = "cuda", seed: int = 0):
        """Build the model with seeded random weights on ``device``
        (``layers.seeded_init``: one seed gives the same model on every
        device)."""
        super().__init__()
        if mode not in MODES:
            raise ValueError(f"mode must be one of {sorted(MODES)}, got "
                             f"{mode!r}")
        dev = resolve_device(device)
        self.cfg = cfg
        self.mode = mode
        if cfg.num_graph_steps > 0:
            self.graph = GraphModule(
                in_size=FEAT_SIZE, out_size=FEAT_SIZE,
                num_layers=cfg.num_graph_steps, num_locals=cfg.num_locals,
                query_mode=cfg.query_mode, graph_mode=cfg.graph_mode,
                graph_aggr=cfg.graph_aggr,
                return_orientation=cfg.use_orientation, num_bins=cfg.num_bins)
        if cfg.use_topdown:
            self.caption = TopDownSceneCaptionModule(
                num_vocabs, emb_size=cfg.emb_size, feat_size=FEAT_SIZE,
                hidden_size=cfg.hidden_size, num_locals=cfg.num_locals,
                query_mode=cfg.query_mode, use_relation=cfg.use_relation,
                max_des_len=cfg.max_des_len, min_iou=cfg.min_iou,
                num_vocabs_padded=num_vocabs_padded,
                use_oracle=mode == "gt")
        else:
            self.caption = SceneCaptionModule(
                num_vocabs, emb_size=cfg.emb_size, feat_size=FEAT_SIZE,
                max_des_len=cfg.max_des_len, min_iou=cfg.min_iou,
                num_vocabs_padded=num_vocabs_padded)
        seeded_init(self, seed)
        self.device = dev           # the device the caller asked for
        self.to(dev)
        self.eval()

    @property
    def num_proposals(self) -> int:
        return MODES[self.mode]

    def forward(self, data_dict: dict, use_tf: bool = True,
                is_eval: bool = False, train: bool = True) -> dict:
        """``train`` is accepted as CapNet takes it (``make_eval_step``
        passes it); the caption-only model has no batch norm."""
        d = dict(data_dict)
        if self.cfg.num_graph_steps > 0:
            d = self.graph(d)
        return self.caption(d, use_tf, is_eval)
