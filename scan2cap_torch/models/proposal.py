"""Proposal module (counterpart of ``scan2cap_tpu/models/proposal.py:27-100``;
reference models/proposal_module.py:22-146).

Vote aggregation (SA over the votes: 256 proposals, r=0.3, 16 samples,
mlp [256, 128, 128, 128]), the detection head, and the box decode on the
device.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from scan2cap_torch.models.backbone import PointnetSAModuleVotes
from scan2cap_torch.models.layers import BatchNorm
from scan2cap_torch.ops.boxes import get_3d_box_batch


class ProposalModule(nn.Module):
    def __init__(self, num_class: int, num_heading_bin: int,
                 num_size_cluster: int, mean_size_arr: np.ndarray,
                 num_proposal: int = 256, seed_feat_dim: int = 256):
        super().__init__()
        self.num_class = num_class
        self.num_heading_bin = num_heading_bin
        self.num_size_cluster = num_size_cluster
        self.register_buffer(
            "mean_size", torch.tensor(np.asarray(mean_size_arr, np.float32)),
            persistent=False)
        self.vote_aggregation = PointnetSAModuleVotes(
            num_proposal, 0.3, 16, seed_feat_dim, (128, 128, 128))
        self.conv1 = nn.Linear(128, 128, bias=False)
        self.bn1 = BatchNorm(128)
        self.conv2 = nn.Linear(128, 128, bias=False)
        self.bn2 = BatchNorm(128)
        out_ch = (2 + 3 + num_heading_bin * 2 + num_size_cluster * 4
                  + num_class)
        self.conv3 = nn.Linear(128, out_ch)

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
        return self.decode_scores(self.conv3(net), d)

    def decode_scores(self, net: torch.Tensor, d: dict) -> dict:
        """Channel slicing + box decode (proposal_module.py:105-144)."""
        NH, NS = self.num_heading_bin, self.num_size_cluster
        B, K, _ = net.shape
        objectness_scores = net[..., 0:2]
        center = d["aggregated_vote_xyz"] + net[..., 2:5]
        heading_scores = net[..., 5:5 + NH]
        heading_res_norm = net[..., 5 + NH:5 + NH * 2]
        size_scores = net[..., 5 + NH * 2:5 + NH * 2 + NS]
        size_res_norm = net[..., 5 + NH * 2 + NS:5 + NH * 2 + NS * 4].reshape(
            B, K, NS, 3)
        sem_cls_scores = net[..., 5 + NH * 2 + NS * 4:]
        mean_size = self.mean_size

        d["objectness_scores"] = objectness_scores
        d["center"] = center
        d["heading_scores"] = heading_scores
        d["heading_residuals_normalized"] = heading_res_norm
        d["heading_residuals"] = heading_res_norm * (math.pi / NH)
        d["size_scores"] = size_scores
        d["size_residuals_normalized"] = size_res_norm
        d["size_residuals"] = size_res_norm * mean_size[None, None]
        d["sem_cls_scores"] = sem_cls_scores

        pred_size_class = torch.argmax(size_scores, dim=-1)          # (B, K)
        pred_size_residual = torch.gather(
            d["size_residuals"], 2,
            pred_size_class[..., None, None].expand(-1, -1, 1, 3))[:, :, 0]
        box_size = mean_size[pred_size_class] + pred_size_residual
        # ScanNet boxes are axis-aligned: heading is always 0
        heading = center.new_zeros((B, K))
        d["bbox_corner"] = get_3d_box_batch(box_size, heading, center)
        d["bbox_feature"] = d["aggregated_vote_features"]
        d["bbox_mask"] = torch.argmax(objectness_scores, dim=-1)      # 0/1
        d["bbox_sems"] = torch.argmax(sem_cls_scores, dim=-1)
        d["sem_cls"] = d["bbox_sems"]
        return d
