"""PointNet++ backbone: 4 SA layers + 2 FP layers
(counterpart of ``scan2cap_tpu/models/backbone.py:79-307``).

Channels-last; every grouping is (B, npoint, nsample, C) and the per-group
PointNet is a SharedMLP followed by a max over the sample axis.

Architecture constants (backbone_module.py:28-66):
  sa1: 2048 pts, r=0.2, 64 smp, mlp [C, 64, 64, 128]
  sa2: 1024 pts, r=0.4, 32 smp, mlp [128, 128, 128, 256]
  sa3:  512 pts, r=0.8, 16 smp, mlp [256, 128, 128, 256]
  sa4:  256 pts, r=1.2, 16 smp, mlp [256, 128, 128, 256]
  fp1/fp2: mlp [256+256, 256, 256]

bfloat16 (``compute_dtype``, ``storage_dtype``, per module through
``bf16_components``) narrows the MLP chains only: the sampling, the ball
query, the gathers and the gather-lean projection stay float32, so FPS,
the first-k and the gather see float32 alone and their indices are the
float32 model's.  Only the grouped values after the centres' subtraction
are narrowed (``scan2cap_tpu/models/backbone.py:183-199``).

``spatial_axis`` (``ModelConfig.spatial_axis``, ``--spatial``) routes each
SA layer's ball query, grouping and sa1 projection through the query-axis
sharding of ``parallel/spatial.py``; FPS stays replicated.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from scan2cap_torch.models.layers import SharedMLP, torch_dtype, widen
from scan2cap_torch.ops import (ball_query, furthest_point_sample,
                                gather_points, group_points,
                                interpolation_weights, query_and_group,
                                three_interpolate, three_nn)
from scan2cap_torch.ops.grouping import group_points_forward
from scan2cap_torch.parallel.spatial import (
    ball_query_sharded, group_points_sharded,
    leaf_gathered_projection_sharded, query_and_group_sharded)


class _LeafGatheredProjection(torch.autograd.Function):
    """group_points(cat @ w0, idx) - (ct_in @ w0)[:, :, None, :] with a
    scatter-free backward (``scan2cap_tpu/models/backbone.py:46-76``).

    The gradient of the neighbour gather is a scatter-add into the (B, N, D)
    projection.  When ``cat`` and ``ct_in`` need no gradient (sa1: they come
    straight from the input cloud), the only consumer is w0, and
    dL/dw0 = gather(cat, idx)^T g - ct_in^T sum_s g: a forward-style gather
    and two small products.  ONLY valid when the point features are leaves
    (``PointnetSAModuleVotes.leaf_inputs``): no gradient is returned for
    ``cat``, ``ct_in`` or ``idx``.  ``w0`` is (in, out)."""

    @staticmethod
    def forward(ctx, cat, ct_in, w0, idx):
        ctx.save_for_backward(cat, ct_in, idx)
        proj = cat @ w0
        ct = ct_in @ w0
        return group_points_forward(proj, idx) - ct[:, :, None, :]

    @staticmethod
    def backward(ctx, g):
        cat, ct_in, idx = ctx.saved_tensors
        g = g.to(cat.dtype)          # a narrow gradient promotes, as in JAX
        gath = group_points_forward(cat, idx)              # (B, M, S, Cin)
        dW = (torch.einsum("bmsc,bmsd->cd", gath, g)
              - torch.einsum("bmc,bmd->cd", ct_in, g.sum(dim=2)))
        return None, None, dW, None


def leaf_gathered_projection(cat: torch.Tensor, ct_in: torch.Tensor,
                             w0: torch.Tensor, idx: torch.Tensor
                             ) -> torch.Tensor:
    """cat (B, N, Cin), ct_in (B, M, Cin), w0 (Cin, D), idx (B, M, S) ->
    (B, M, S, D); differentiable in ``w0`` only."""
    return _LeafGatheredProjection.apply(cat, ct_in, w0, idx)


class PointnetSAModuleVotes(nn.Module):
    """Single-scale set-abstraction layer (pointnet2_modules.py:164-272).

    ``in_features`` is the width of the point features (without xyz).
    ``compute_dtype`` / ``storage_dtype`` narrow the MLP chain
    (``SharedMLP``) and the grouped values that enter it.
    ``spatial_axis`` splits the query axis over that mesh axis."""

    def __init__(self, npoint: int, radius: float, nsample: int,
                 in_features: int, mlp: Sequence[int], use_xyz: bool = True,
                 normalize_xyz: bool = True, leaf_inputs: bool = False,
                 compute_dtype: Optional[str] = None,
                 storage_dtype: Optional[str] = None,
                 spatial_axis: str = ""):
        super().__init__()
        self.spatial_axis = spatial_axis
        self.npoint = npoint
        self.radius = radius
        self.nsample = nsample
        self.use_xyz = use_xyz
        self.normalize_xyz = normalize_xyz
        self.in_features = in_features
        in_width = in_features + (3 if use_xyz else 0)
        self.mlp = SharedMLP(in_width, mlp, compute_dtype=compute_dtype,
                             storage_dtype=storage_dtype)
        # the dtype the grouped values enter the MLP chain in (None: float32)
        self.narrow = torch_dtype(compute_dtype) or torch_dtype(storage_dtype)
        # gather-lean path: project every source point through the
        # bias-free layer 0 once and gather the narrow projection instead
        # of the wide raw features (scan2cap_tpu/models/backbone.py:131-181)
        self.gather_lean = use_xyz and in_width > mlp[0]
        # the input xyz/features are autograd leaves (raw data, not
        # activations): enables the scatter-free backward of the gather-lean
        # projection.  Do NOT set on a layer fed by earlier layers: their
        # feature gradients would be dropped.
        self.leaf_inputs = leaf_inputs

    def forward(self, xyz: torch.Tensor, features: Optional[torch.Tensor],
                inds: Optional[torch.Tensor] = None, train: bool = False,
                bn_momentum: float = 0.1
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        if inds is None:
            inds = furthest_point_sample(xyz, self.npoint)
        new_xyz = gather_points(xyz, inds)                  # (B, npoint, 3)
        sp = self.spatial_axis
        if self.gather_lean:
            # Dense_0([xyz_j - xyz_c; f_j]) == Dense_0([xyz_j; f_j])
            #                                  - Dense_0([xyz_c; 0])
            idx = (ball_query_sharded(xyz, new_xyz, self.radius,
                                      self.nsample, sp) if sp
                   else ball_query(xyz, new_xyz, self.radius, self.nsample))
            scale = 1.0 / self.radius if self.normalize_xyz else 1.0
            # the split runs in float32 whatever the features' dtype
            feats = widen(features) if features is not None else None
            xyz_s = xyz * scale
            cat = torch.cat([xyz_s, feats], -1) if feats is not None \
                else xyz_s
            ct_in = new_xyz * scale
            if feats is not None:
                ct_in = torch.cat(
                    [ct_in, ct_in.new_zeros(ct_in.shape[:-1]
                                            + (feats.shape[-1],))], -1)
            if self.leaf_inputs:
                w0 = self.mlp.dense_0.weight.t()
                g = (leaf_gathered_projection_sharded(
                         leaf_gathered_projection, cat, ct_in, w0, idx, sp)
                     if sp else leaf_gathered_projection(cat, ct_in, w0, idx))
            else:
                proj = self.mlp.project_first(cat)          # (B, N, w0)
                ct = self.mlp.project_first(ct_in)          # (B, npoint, w0)
                gathered = (group_points_sharded(proj, idx, sp) if sp
                            else group_points(proj, idx))
                g = gathered - ct[:, :, None, :]
            if self.narrow is not None:
                # relative-scale values only from here on
                g = g.to(self.narrow)
            out = self.mlp.from_first(g, train, bn_momentum)
        else:
            # grouped in float32 and narrowed after: a gather commutes with
            # the cast, so this is the JAX package's narrow-then-group
            group = (query_and_group_sharded if sp else query_and_group)
            extra = dict(axis=sp) if sp else {}
            grouped = group(
                xyz, new_xyz, widen(features) if features is not None
                else None, self.radius, self.nsample, use_xyz=self.use_xyz,
                normalize_xyz=self.normalize_xyz, **extra)
            if self.narrow is not None:
                grouped = grouped.to(self.narrow)
            out = self.mlp(grouped, train, bn_momentum)
        return new_xyz, out.amax(dim=2), inds


class PointnetFPModule(nn.Module):
    """Feature-propagation layer (pointnet2_modules.py:356-416).  With a
    narrowed upstream, ``three_interpolate`` takes bfloat16 features and
    float32 weights and returns float32, as in JAX."""

    def __init__(self, in_features: int, mlp: Sequence[int],
                 compute_dtype: Optional[str] = None,
                 storage_dtype: Optional[str] = None):
        super().__init__()
        self.mlp = SharedMLP(in_features, mlp, compute_dtype=compute_dtype,
                             storage_dtype=storage_dtype)

    def forward(self, unknown: torch.Tensor, known: torch.Tensor,
                unknown_feats: Optional[torch.Tensor],
                known_feats: torch.Tensor, train: bool = False,
                bn_momentum: float = 0.1) -> torch.Tensor:
        dist, idx = three_nn(unknown, known)
        weight = interpolation_weights(dist)
        interpolated = three_interpolate(known_feats, idx, weight)
        if unknown_feats is not None:
            new_features = torch.cat([interpolated, unknown_feats], dim=-1)
        else:
            new_features = interpolated
        return self.mlp(new_features, train, bn_momentum)


class Pointnet2Backbone(nn.Module):
    """models/backbone_module.py:22-127, channels-last; fills the same
    data-dict keys as the JAX module.  ``compute_dtype`` and
    ``storage_dtype`` apply to the modules named in ``bf16_components``
    ("sa1,...,sa4,fp"); the others stay float32, bit for bit.  With
    ``compute_dtype`` the SA and FP features come out narrow.
    ``spatial_axis`` applies to the four SA layers."""

    def __init__(self, input_feature_dim: int = 0,
                 sa_npoints: Tuple[int, int, int, int] = (2048, 1024, 512, 256),
                 compute_dtype: Optional[str] = None,
                 storage_dtype: Optional[str] = None,
                 bf16_components: str = "sa1,sa2,sa3,sa4,fp",
                 spatial_axis: str = ""):
        super().__init__()
        np1, np2, np3, np4 = sa_npoints
        comps = {c.strip() for c in bf16_components.split(",")}

        def dt(name):
            out = dict(
                compute_dtype=compute_dtype if name in comps else None,
                storage_dtype=storage_dtype if name in comps else None)
            if name.startswith("sa"):
                out["spatial_axis"] = spatial_axis
            return out

        # sa1's xyz/features come straight from the input cloud
        self.sa1 = PointnetSAModuleVotes(np1, 0.2, 64, input_feature_dim,
                                         (64, 64, 128), leaf_inputs=True,
                                         **dt("sa1"))
        self.sa2 = PointnetSAModuleVotes(np2, 0.4, 32, 128, (128, 128, 256),
                                         **dt("sa2"))
        self.sa3 = PointnetSAModuleVotes(np3, 0.8, 16, 256, (128, 128, 256),
                                         **dt("sa3"))
        self.sa4 = PointnetSAModuleVotes(np4, 1.2, 16, 256, (128, 128, 256),
                                         **dt("sa4"))
        self.fp1 = PointnetFPModule(256 + 256, (256, 256), **dt("fp"))
        self.fp2 = PointnetFPModule(256 + 256, (256, 256), **dt("fp"))

    def forward(self, data_dict: dict, train: bool = False,
                bn_momentum: float = 0.1) -> dict:
        pc = data_dict["point_clouds"]
        xyz = pc[..., :3].contiguous()
        features = pc[..., 3:] if pc.shape[-1] > 3 else None
        d = dict(data_dict)

        xyz, features, inds = self.sa1(xyz, features, None, train, bn_momentum)
        d["sa1_inds"], d["sa1_xyz"], d["sa1_features"] = inds, xyz, features
        xyz, features, inds = self.sa2(xyz, features, None, train, bn_momentum)
        d["sa2_inds"], d["sa2_xyz"], d["sa2_features"] = inds, xyz, features
        xyz, features, _ = self.sa3(xyz, features, None, train, bn_momentum)
        d["sa3_xyz"], d["sa3_features"] = xyz, features
        xyz, features, _ = self.sa4(xyz, features, None, train, bn_momentum)
        d["sa4_xyz"], d["sa4_features"] = xyz, features

        features = self.fp1(d["sa3_xyz"], d["sa4_xyz"], d["sa3_features"],
                            d["sa4_features"], train, bn_momentum)
        features = self.fp2(d["sa2_xyz"], d["sa3_xyz"], d["sa2_features"],
                            features, train, bn_momentum)
        d["fp2_features"] = features                         # (B, 1024, 256)
        d["fp2_xyz"] = d["sa2_xyz"]
        # sa2 sampled from sa1's points, whose FPS inds are 0..1023, so the
        # seeds' indices into the raw cloud are sa1_inds[:, :1024]
        d["fp2_inds"] = d["sa1_inds"][:, :d["fp2_xyz"].shape[1]]
        return d
