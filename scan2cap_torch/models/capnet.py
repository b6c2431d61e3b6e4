"""CapNet — detect-then-describe pipeline
(counterpart of ``scan2cap_tpu/models/capnet.py:27-126``).

backbone -> voting (+ L2 feature norm) -> proposal -> [graph] -> [caption].
Module attribute names follow the Flax tree, so the state_dict keys are the
Flax paths joined by dots (``backbone_net.sa1.mlp.dense_0.weight``).

Each child's forward goes through the model's ``stage_graphs``
(``models/stage_graph``): under ``inference_mode`` or ``no_grad`` on a
card it replays as CUDA graph segments, inside the child's call.  Its
outputs are then the graphs' buffers, which the next forward overwrites;
``train.step.make_eval_step`` and ``scripts/export_model.Serve`` clone
what they return.
The vote features' L2 norm between ``vgen`` and ``proposal`` runs eager.
"""

from __future__ import annotations

import torch
from torch import nn

from scan2cap_torch.config import ModelConfig, SCANNET_MEAN_SIZE_ARR
from scan2cap_torch.device import resolve_device
from scan2cap_torch.models.backbone import Pointnet2Backbone
from scan2cap_torch.models.caption import (SceneCaptionModule,
                                           TopDownSceneCaptionModule)
from scan2cap_torch.models.graph import GraphModule
from scan2cap_torch.models.layers import seeded_init, widen
from scan2cap_torch.models.proposal import ProposalModule
from scan2cap_torch.models.stage_graph import STAGES, StageGraphs
from scan2cap_torch.models.voting import VotingModule, l2_normalize_votes
from scan2cap_torch.utils.profiling import annotate


class CapNet(nn.Module):
    def __init__(self, cfg: ModelConfig, num_vocabs: int = 4,
                 num_vocabs_padded: int = 0, device: str | torch.device = "cuda",
                 seed: int = 0):
        """Build the model with seeded random weights on ``device``.

        Weights are drawn on the CPU from ``torch.Generator().manual_seed(seed)``
        (Linear weights N(0, 1/fan_in), biases 0, BN scale 1 and shift 0),
        so one seed gives the same model on every device."""
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.backbone_net = Pointnet2Backbone(
            cfg.input_feature_dim, cfg.sa_npoints,
            compute_dtype=cfg.compute_dtype,
            storage_dtype=cfg.storage_dtype,
            bf16_components=cfg.bf16_components,
            spatial_axis=cfg.spatial_axis)
        self.vgen = VotingModule(cfg.vote_factor, 256)
        self.proposal = ProposalModule(
            cfg.num_class, cfg.num_heading_bin, cfg.num_size_cluster,
            SCANNET_MEAN_SIZE_ARR, cfg.num_proposals, 256)
        if cfg.num_graph_steps > 0:
            self.graph = GraphModule(
                in_size=128, out_size=128, num_layers=cfg.num_graph_steps,
                num_locals=cfg.num_locals, query_mode=cfg.query_mode,
                graph_mode=cfg.graph_mode, graph_aggr=cfg.graph_aggr,
                return_orientation=cfg.use_orientation, num_bins=cfg.num_bins)
        if not cfg.no_caption and cfg.use_topdown:
            self.caption = TopDownSceneCaptionModule(
                num_vocabs, emb_size=cfg.emb_size, feat_size=128,
                hidden_size=cfg.hidden_size, num_locals=cfg.num_locals,
                query_mode=cfg.query_mode, use_relation=cfg.use_relation,
                max_des_len=cfg.max_des_len, min_iou=cfg.min_iou,
                num_vocabs_padded=num_vocabs_padded)
        elif not cfg.no_caption:
            self.caption = SceneCaptionModule(
                num_vocabs, emb_size=cfg.emb_size, feat_size=128,
                max_des_len=cfg.max_des_len, min_iou=cfg.min_iou,
                num_vocabs_padded=num_vocabs_padded)
        self.stage_graphs = StageGraphs()
        for name in STAGES:
            if name in self._modules:
                self.stage_graphs.install(name, self._modules[name])
        seeded_init(self, seed)
        self.device = dev           # the device the caller asked for
        self.to(dev)
        self.eval()

    def forward(self, data_dict: dict, use_tf: bool = False,
                is_eval: bool = True, train: bool = False,
                bn_momentum: float = 0.1) -> dict:
        """The forward's every output.  Under ``inference_mode`` or
        ``no_grad`` on a card these may be the stage graphs' buffers,
        which the model's next forward overwrites: a caller that keeps
        them past it takes ``stage_graph.kept(model, ...)`` of them."""
        cfg = self.cfg
        with annotate("scan2cap.backbone"):
            d = self.backbone_net(data_dict, train, bn_momentum)
        d["seed_inds"] = d["fp2_inds"]
        d["seed_xyz"] = d["fp2_xyz"]
        d["seed_features"] = d["fp2_features"]
        with annotate("scan2cap.vote"):
            # a bfloat16 backbone's seed features enter the float32 voting
            # layers promoted, as JAX promotes them
            vote_xyz, vote_features = self.vgen(
                d["fp2_xyz"], widen(d["fp2_features"]), train, bn_momentum)
            vote_features = l2_normalize_votes(vote_features)
        d["vote_xyz"] = vote_xyz
        d["vote_features"] = vote_features
        with annotate("scan2cap.proposal"):
            d = self.proposal(vote_xyz, vote_features, d, train, bn_momentum)
        if cfg.num_graph_steps > 0:
            with annotate("scan2cap.graph"):
                d = self.graph(d)
        if not cfg.no_caption:
            with annotate("scan2cap.caption"):
                d = self.caption(d, use_tf, is_eval)
        return d
