"""MaskVoteNet, the single-proposal feature extractor
(counterpart of ``scan2cap_tpu/models/mask_votenet.py:25-83``; reference
models/mask_votenet.py).

The backbone and voting of CapNet over an input with one more channel, the
binary mask of the target object, then a proposal module that aggregates
all the votes into ONE proposal with a large ball (radius 5 m, 512 samples)
and predicts only its centre offset, size class and residual and semantic
class.  Module attribute names follow the Flax tree, as in CapNet, so the
reference's VoteNet ``.pth`` layout carries it both ways.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from scan2cap_torch.config import ModelConfig, SCANNET_MEAN_SIZE_ARR
from scan2cap_torch.device import resolve_device
from scan2cap_torch.models.backbone import (Pointnet2Backbone,
                                            PointnetSAModuleVotes)
from scan2cap_torch.models.layers import BatchNorm, seeded_init
from scan2cap_torch.models.voting import VotingModule, l2_normalize_votes

# the vote aggregation's ball (mask_votenet.py:145-153 of the reference)
AGGREGATION_RADIUS = 5.0
AGGREGATION_NSAMPLE = 512


class MaskProposalModule(nn.Module):
    def __init__(self, num_class: int = 18, num_size_cluster: int = 18,
                 num_proposal: int = 1, seed_feat_dim: int = 256):
        super().__init__()
        self.num_size_cluster = num_size_cluster
        self.register_buffer(
            "mean_size", torch.tensor(np.asarray(SCANNET_MEAN_SIZE_ARR,
                                                 np.float32)),
            persistent=False)
        self.vote_aggregation = PointnetSAModuleVotes(
            num_proposal, AGGREGATION_RADIUS, AGGREGATION_NSAMPLE,
            seed_feat_dim, (128, 128, 128))
        self.conv1 = nn.Linear(128, 128, bias=False)
        self.bn1 = BatchNorm(128)
        self.conv2 = nn.Linear(128, 128, bias=False)
        self.bn2 = BatchNorm(128)
        self.conv3 = nn.Linear(128, 3 + num_size_cluster * 4 + num_class)

    def forward(self, xyz: torch.Tensor, features: torch.Tensor,
                data_dict: dict, train: bool = False,
                bn_momentum: float = 0.1) -> dict:
        d = dict(data_dict)
        agg_xyz, agg_features, fps_inds = self.vote_aggregation(
            xyz, features, None, train, bn_momentum)
        d["aggregated_vote_xyz"] = agg_xyz                 # (B, K, 3)
        d["aggregated_vote_features"] = agg_features       # (B, K, 128)
        d["aggregated_vote_inds"] = fps_inds
        net = torch.relu(self.bn1(self.conv1(agg_features), train, bn_momentum))
        net = torch.relu(self.bn2(self.conv2(net), train, bn_momentum))
        net = self.conv3(net)

        NS = self.num_size_cluster
        B, K, _ = net.shape
        d["center"] = agg_xyz + net[..., 0:3]
        d["size_scores"] = net[..., 3:3 + NS]
        size_res_norm = net[..., 3 + NS:3 + NS * 4].reshape(B, K, NS, 3)
        d["size_residuals_normalized"] = size_res_norm
        d["size_residuals"] = size_res_norm * self.mean_size[None, None]
        d["sem_cls_scores"] = net[..., 3 + NS * 4:]
        return d


class MaskVoteNet(nn.Module):
    def __init__(self, cfg: ModelConfig, device: str | torch.device = "cuda",
                 seed: int = 0):
        """Build the model with seeded random weights on ``device``
        (``layers.seeded_init``: one seed gives the same model on every
        device)."""
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        # +1 input channel: the binary target mask
        self.backbone_net = Pointnet2Backbone(cfg.input_feature_dim + 1,
                                              cfg.sa_npoints)
        self.vgen = VotingModule(cfg.vote_factor, 256)
        self.proposal = MaskProposalModule(
            cfg.num_class, cfg.num_size_cluster, cfg.num_proposals, 256)
        seeded_init(self, seed)
        self.device = dev           # the device the caller asked for
        self.to(dev)
        self.eval()

    def forward(self, data_dict: dict, train: bool = False,
                bn_momentum: float = 0.1) -> dict:
        d = self.backbone_net(data_dict, train, bn_momentum)
        d["seed_inds"] = d["fp2_inds"]
        d["seed_xyz"] = d["fp2_xyz"]
        d["seed_features"] = d["fp2_features"]
        vote_xyz, vote_features = self.vgen(d["fp2_xyz"], d["fp2_features"],
                                            train, bn_momentum)
        vote_features = l2_normalize_votes(vote_features)
        d["vote_xyz"] = vote_xyz
        d["vote_features"] = vote_features
        return self.proposal(vote_xyz, vote_features, d, train, bn_momentum)
