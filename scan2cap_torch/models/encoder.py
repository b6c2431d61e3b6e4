"""PointNet++ object encoder (counterpart of
``scan2cap_tpu/models/encoder.py``; reference models/encoder_module.py).

SA1-4 -> global max-pool -> a 128-d mapped feature and a ``num_classes``
classifier.  ``whole_scene`` encodes every object crop of a scene: the
object axis folds into the batch (B x M crops in one pass, so one FPS, one
ball-query and one gather launch a layer) and the invalid crops are zeroed.
Whole-scene mode is for evaluation and extraction only: train-mode batch
norm would fold the zero-padded crops into its statistics, so it refuses
``train=True`` as the JAX module does (encoder.py:54-74).
"""

from __future__ import annotations

import torch
from torch import nn

from scan2cap_torch.device import resolve_device
from scan2cap_torch.models.backbone import PointnetSAModuleVotes
from scan2cap_torch.models.layers import seeded_init

FEAT_SIZE = 128


class PointnetEncoder(nn.Module):
    def __init__(self, input_feature_dim: int = 0, num_classes: int = 18,
                 whole_scene: bool = False,
                 sa_npoints=(2048, 1024, 512, 256),
                 device: str | torch.device = "cuda", seed: int = 0):
        """``input_feature_dim``: the point features' width after xyz.
        Seeded random weights on ``device`` (``layers.seeded_init``)."""
        super().__init__()
        dev = resolve_device(device)
        self.input_feature_dim = input_feature_dim
        self.num_classes = num_classes
        self.whole_scene = whole_scene
        np1, np2, np3, np4 = sa_npoints
        # the crops are raw data (autodiff leaves): sa1's scatter-free
        # backward applies as in the backbone
        self.sa1 = PointnetSAModuleVotes(np1, 0.2, 64, input_feature_dim,
                                         (64, 64, 128), leaf_inputs=True)
        self.sa2 = PointnetSAModuleVotes(np2, 0.4, 32, 128, (128, 128, 256))
        self.sa3 = PointnetSAModuleVotes(np3, 0.8, 16, 256, (128, 128, 256))
        self.sa4 = PointnetSAModuleVotes(np4, 1.2, 16, 256, (128, 128, 256))
        self.map = nn.Linear(256, FEAT_SIZE)
        self.classifier = nn.Linear(FEAT_SIZE, num_classes)
        seeded_init(self, seed)
        self.device = dev           # the device the caller asked for
        self.to(dev)
        self.eval()

    def encode(self, pc: torch.Tensor, train: bool, bn_momentum: float):
        """(B', N, 3 + C) crops -> (features (B', 128), logits (B', cls))."""
        xyz = pc[..., :3].contiguous()
        features = pc[..., 3:] if pc.shape[-1] > 3 else None
        for sa in (self.sa1, self.sa2, self.sa3, self.sa4):
            xyz, features, _ = sa(xyz, features, None, train, bn_momentum)
        pooled = features.amax(dim=1)                       # (B', 256)
        feat = torch.relu(self.map(pooled))
        return feat, self.classifier(feat)

    def forward(self, data_dict: dict, train: bool = True,
                bn_momentum: float = 0.1) -> dict:
        d = dict(data_dict)
        pc = d["point_clouds"]
        if not self.whole_scene:
            d["enc_features"], d["enc_preds"] = self.encode(pc, train,
                                                            bn_momentum)
            return d
        if train:
            raise ValueError(
                "PointnetEncoder(whole_scene=True) is eval/extraction-only: "
                "train with per-object crops (whole_scene=False) and reuse "
                "the weights for whole-scene encoding")
        B, M, N, C = pc.shape
        feat, preds = self.encode(pc.reshape(B * M, N, C), train, bn_momentum)
        mask = d["target_masks"][..., None].to(feat.dtype)
        d["enc_features"] = feat.reshape(B, M, FEAT_SIZE) * mask
        d["enc_preds"] = preds.reshape(B, M, self.num_classes) * mask
        return d
