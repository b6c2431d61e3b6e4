"""The models of the reference: CapNet (PointNet++ backbone, voting,
proposals, relational graph, top-down caption decoder) and MaskVoteNet.

A frozen copy of the arithmetic of ``scan2cap_torch.models`` as it stood
when the benchmark was written, float32 only and without a mesh, over the
plain operations of ``reference.ops``.  Module and parameter names are the
port's, so one state dict loads into both.  The eval decode is forced: it
feeds the tokens it is given instead of its own picks, and reports the
logit gap of the tokens it is asked to read.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from h100bench.reference import ops


class Linear(nn.Linear):
    def forward(self, x):
        return ops.linear(x, self.weight, self.bias)


class BatchNorm(nn.Module):
    """Batch norm over the trailing axis, the momentum passed per call;
    train mode normalises with the biased variance and keeps the unbiased
    one."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x, train=False, momentum=0.1):
        if train:
            dims = tuple(range(x.dim() - 1))
            n = x.numel() // x.shape[-1]
            mean = x.mean(dim=dims)
            var = x.var(dim=dims, unbiased=False)
            with torch.no_grad():
                unbiased = var * (n / max(n - 1, 1))
                self.running_mean.mul_(1.0 - momentum).add_(momentum * mean)
                self.running_var.mul_(1.0 - momentum).add_(momentum * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean) * inv + self.bias


class SharedMLP(nn.Module):
    """Linear (no bias), BatchNorm and ReLU layers over the trailing
    axis."""

    def __init__(self, in_features: int, features: Sequence[int]):
        super().__init__()
        self.num_layers = len(features)
        widths = [in_features, *features]
        for i, w in enumerate(features):
            self.add_module(f"dense_{i}", Linear(widths[i], w, bias=False))
            self.add_module(f"bn_{i}", BatchNorm(w))

    def _post(self, x, i, train, m):
        return torch.relu(getattr(self, f"bn_{i}")(x, train, m))

    def forward(self, x, train=False, m=0.1):
        for i in range(self.num_layers):
            x = self._post(getattr(self, f"dense_{i}")(x), i, train, m)
        return x

    def from_first(self, x, train=False, m=0.1):
        x = self._post(x, 0, train, m)
        for i in range(1, self.num_layers):
            x = self._post(getattr(self, f"dense_{i}")(x), i, train, m)
        return x


class GRUCell(nn.Module):
    """Gates (r, z, n) from one fused input and one fused hidden
    projection."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.ih = Linear(input_size, 3 * hidden_size)
        self.hh = Linear(hidden_size, 3 * hidden_size)

    def forward(self, x, h):
        i_r, i_z, i_n = self.ih(x).chunk(3, dim=-1)
        h_r, h_z, h_n = self.hh(h).chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        return (1.0 - z) * n + z * h


class _LeafProjection(torch.autograd.Function):
    """group(cat @ w0, idx) - (ct_in @ w0)[:, :, None] over point
    features that need no gradient; the gradient of w0 without a
    scatter."""

    @staticmethod
    def forward(ctx, cat, ct_in, w0, idx):
        ctx.save_for_backward(cat, ct_in, idx)
        proj = ops.matmul(cat, w0)
        ct = ops.matmul(ct_in, w0)
        return ops.group_points(proj, idx) - ct[:, :, None, :]

    @staticmethod
    def backward(ctx, g):
        cat, ct_in, idx = ctx.saved_tensors
        gath = ops.group_points(cat, idx)
        dW = (ops.einsum("bmsc,bmsd->cd", gath, g)
              - ops.einsum("bmc,bmd->cd", ct_in, g.sum(dim=2)))
        return None, None, dW, None


class SetAbstraction(nn.Module):
    """Sampling, ball query, grouping and a per-group PointNet, with
    normalised offsets.  Layer 0 runs over the source points before the
    gather: Dense_0([xyz_j - xyz_c; f_j]) == Dense_0([xyz_j; f_j]) -
    Dense_0([xyz_c; 0])."""

    def __init__(self, npoint, radius, nsample, in_features, mlp,
                 leaf_inputs=False):
        super().__init__()
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        if in_features + 3 <= mlp[0]:
            raise ValueError("every layer of these models projects before "
                             "the gather")
        self.mlp = SharedMLP(in_features + 3, mlp)
        self.leaf_inputs = leaf_inputs

    def forward(self, xyz, features, train=False, m=0.1):
        inds = ops.furthest_point_sample(xyz, self.npoint)
        new_xyz = ops.gather_points(xyz, inds)
        idx = ops.ball_query(xyz, new_xyz, self.radius, self.nsample)
        scale = 1.0 / self.radius
        xyz_s = xyz * scale
        cat = torch.cat([xyz_s, features], -1) if features is not None \
            else xyz_s
        ct_in = new_xyz * scale
        if features is not None:
            ct_in = torch.cat([ct_in, ct_in.new_zeros(
                ct_in.shape[:-1] + (features.shape[-1],))], -1)
        if self.leaf_inputs:
            g = _LeafProjection.apply(cat, ct_in, self.mlp.dense_0.weight.t(),
                                      idx)
        else:
            proj = self.mlp.dense_0(cat)
            ct = self.mlp.dense_0(ct_in)
            g = ops.group_points(proj, idx) - ct[:, :, None, :]
        out = self.mlp.from_first(g, train, m)
        return new_xyz, out.amax(dim=2), inds


class FeaturePropagation(nn.Module):
    def __init__(self, in_features, mlp):
        super().__init__()
        self.mlp = SharedMLP(in_features, mlp)

    def forward(self, unknown, known, unknown_feats, known_feats, train=False,
                m=0.1):
        dist, idx = ops.three_nn(unknown, known)
        interpolated = ops.three_interpolate(
            known_feats, idx, ops.interpolation_weights(dist))
        return self.mlp(torch.cat([interpolated, unknown_feats], dim=-1),
                        train, m)


class Backbone(nn.Module):
    def __init__(self, input_feature_dim, sa_npoints):
        super().__init__()
        np1, np2, np3, np4 = sa_npoints
        self.sa1 = SetAbstraction(np1, 0.2, 64, input_feature_dim,
                                  (64, 64, 128), leaf_inputs=True)
        self.sa2 = SetAbstraction(np2, 0.4, 32, 128, (128, 128, 256))
        self.sa3 = SetAbstraction(np3, 0.8, 16, 256, (128, 128, 256))
        self.sa4 = SetAbstraction(np4, 1.2, 16, 256, (128, 128, 256))
        self.fp1 = FeaturePropagation(512, (256, 256))
        self.fp2 = FeaturePropagation(512, (256, 256))

    def forward(self, d, train=False, m=0.1):
        pc = d["point_clouds"]
        xyz = pc[..., :3].contiguous()
        features = pc[..., 3:] if pc.shape[-1] > 3 else None
        d = dict(d)
        xyz1, f1, i1 = self.sa1(xyz, features, train, m)
        xyz2, f2, _ = self.sa2(xyz1, f1, train, m)
        xyz3, f3, _ = self.sa3(xyz2, f2, train, m)
        xyz4, f4, _ = self.sa4(xyz3, f3, train, m)
        f = self.fp1(xyz3, xyz4, f3, f4, train, m)
        f = self.fp2(xyz2, xyz3, f2, f, train, m)
        d["seed_xyz"], d["seed_features"] = xyz2, f
        d["seed_inds"] = i1[:, :xyz2.shape[1]]
        return d


class Voting(nn.Module):
    def __init__(self, C=256):
        super().__init__()
        self.conv1, self.bn1 = Linear(C, C), BatchNorm(C)
        self.conv2, self.bn2 = Linear(C, C), BatchNorm(C)
        self.conv3 = Linear(C, 3 + C)

    def forward(self, seed_xyz, seed_features, train=False, m=0.1):
        net = torch.relu(self.bn1(self.conv1(seed_features), train, m))
        net = torch.relu(self.bn2(self.conv2(net), train, m))
        net = self.conv3(net)
        vote_xyz = seed_xyz + net[..., 0:3]
        vote_features = seed_features + net[..., 3:]
        return vote_xyz, vote_features / torch.linalg.vector_norm(
            vote_features, dim=-1, keepdim=True)


def _mean_size(device):
    return torch.tensor(ops.MEAN_SIZE, dtype=torch.float32, device=device)


class Proposal(nn.Module):
    """Vote aggregation and the detection head; ``single`` is MaskVoteNet's
    head (centre, size and class of one proposal)."""

    def __init__(self, num_proposal, radius, nsample, single=False):
        super().__init__()
        self.single = single
        self.vote_aggregation = SetAbstraction(num_proposal, radius, nsample,
                                               256, (128, 128, 128))
        self.conv1, self.bn1 = Linear(128, 128, bias=False), BatchNorm(128)
        self.conv2, self.bn2 = Linear(128, 128, bias=False), BatchNorm(128)
        self.conv3 = Linear(128, (3 if single else 7) + 18 * 4 + 18)

    def forward(self, xyz, features, d, train=False, m=0.1):
        d = dict(d)
        agg_xyz, agg_feat, _ = self.vote_aggregation(xyz, features, train, m)
        d["aggregated_vote_xyz"] = agg_xyz
        net = torch.relu(self.bn1(self.conv1(agg_feat), train, m))
        net = torch.relu(self.bn2(self.conv2(net), train, m))
        net = self.conv3(net)
        B, K, _ = net.shape
        mean_size = _mean_size(net.device)
        if self.single:
            d["center"] = agg_xyz + net[..., 0:3]
            d["size_scores"] = net[..., 3:21]
            d["size_residuals_normalized"] = net[..., 21:75].reshape(B, K, 18, 3)
            d["size_residuals"] = d["size_residuals_normalized"] * mean_size
            d["sem_cls_scores"] = net[..., 75:]
            return d
        d["objectness_scores"] = net[..., 0:2]
        center = agg_xyz + net[..., 2:5]
        d["center"] = center
        d["heading_scores"] = net[..., 5:6]
        d["heading_residuals_normalized"] = net[..., 6:7]
        d["size_scores"] = net[..., 7:25]
        d["size_residuals_normalized"] = net[..., 25:79].reshape(B, K, 18, 3)
        d["size_residuals"] = d["size_residuals_normalized"] * mean_size
        d["sem_cls_scores"] = net[..., 79:]
        size_class = torch.argmax(d["size_scores"], dim=-1)
        residual = torch.gather(
            d["size_residuals"], 2,
            size_class[..., None, None].expand(-1, -1, 1, 3))[:, :, 0]
        d["bbox_corner"] = ops.box_corners(mean_size[size_class] + residual,
                                           center)
        d["bbox_feature"] = agg_feat
        d["bbox_mask"] = torch.argmax(d["objectness_scores"], dim=-1)
        return d


# ------------------------------------------------------------ graph
def bbox_centers(corners):
    return (corners.amin(dim=-2) + corners.amax(dim=-2)) / 2.0


def norm3(diff):
    return torch.sqrt(ops.sq_dist_reduce(diff[..., 0], diff[..., 1],
                                         diff[..., 2]) + 1e-8)


def topk_locals(dist, invalid, iou, self_mask, num_locals, include_self,
                overlay=0.5):
    """The ``num_locals`` nearest proposals: invalid and overlapping ones
    (IoU >= 0.5) pushed to 1e30, the proposal itself first or last, ties
    to the lower index."""
    inf = torch.tensor(1e30, dtype=dist.dtype, device=dist.device)
    dist = torch.where(invalid, inf, dist)
    dist = torch.where(iou >= overlay, inf, dist)
    dist = torch.where(self_mask, torch.zeros_like(dist) if include_self
                       else inf, dist)
    return torch.sort(dist, dim=-1, stable=True).indices[..., :num_locals]


def locals_all(corners, valid, num_locals, include_self):
    """(B, K, K) 0/1 masks and (B, K, L) ascending neighbour ids of every
    proposal."""
    B, K = valid.shape
    corners = corners.detach()
    centers = bbox_centers(corners)
    dist = norm3(centers[:, :, None, :] - centers[:, None, :, :])
    iou = ops.box3d_iou_matrix(corners, corners)
    eye = torch.eye(K, dtype=torch.bool, device=corners.device)[None]
    topk = topk_locals(dist, (valid == 0)[:, None, :], iou, eye, num_locals,
                       include_self)
    masks = torch.zeros((B, K, K), dtype=torch.float32, device=corners.device)
    masks.scatter_(2, topk, 1.0)
    return masks, torch.sort(topk, dim=-1).values


def gather_slots(x, idx):
    """(B, K, C), (B, K, L) -> (B, K, L, C)."""
    B, K, L = idx.shape
    return torch.gather(x, 1, idx.reshape(B, K * L).long()[..., None].expand(
        -1, -1, x.shape[-1])).reshape(B, K, L, -1)


class EdgeConv(nn.Module):
    def __init__(self, size=128):
        super().__init__()
        self.map_edge_0 = Linear(2 * size, size)
        self.map_edge_1 = Linear(size, size)

    def forward(self, x, nbr, edge_mask):
        B, K, C = x.shape
        L = nbr.shape[-1]
        x_tgt = gather_slots(x, nbr)
        edge_in = torch.cat([x_tgt, x[:, :, None, :] - x_tgt], dim=-1)
        msg = self.map_edge_1(torch.relu(self.map_edge_0(edge_in)))
        msg = msg * edge_mask[..., None]
        seg = (nbr.long() + (torch.arange(B, device=x.device) * K)[:, None, None]
               ).reshape(-1)
        node = msg.new_zeros((B * K, C)).index_add_(0, seg,
                                                    msg.reshape(B * K * L, C))
        return node.reshape(B, K, C), msg


class Graph(nn.Module):
    """Two EdgeConv layers over each proposal's ``num_locals`` nearest,
    the edge orientation head, and the skip connection."""

    def __init__(self, num_layers, num_locals, num_bins):
        super().__init__()
        self.num_layers, self.num_locals = num_layers, num_locals
        for i in range(num_layers):
            self.add_module(f"gc_{i}", EdgeConv())
        self.edge_layer = EdgeConv()
        self.edge_predict = Linear(128, num_bins + 1)

    def forward(self, d):
        d = dict(d)
        feats = d["bbox_feature"]
        valid = d["bbox_mask"].float()
        B, K, _ = feats.shape
        L = self.num_locals
        _, nbr = locals_all(d["bbox_corner"], valid, L, include_self=False)
        nbr_valid = torch.gather(valid, 1, nbr.reshape(B, K * L)
                                 ).reshape(B, K, L)
        edge_mask = valid[:, :, None] * nbr_valid
        feat, msg = feats, None
        for i in range(self.num_layers):
            feat, msg = getattr(self, f"gc_{i}")(feat, nbr, edge_mask)
        _, edge_msg = self.edge_layer(feat, nbr, edge_mask)
        d["edge_orientations"] = self.edge_predict(edge_msg)[..., :-1]
        d["bbox_feature"] = (feats + feat) * valid[..., None]
        d["edge_feature"] = msg
        d["edge_nbr_idx"] = nbr
        d["edge_mask"] = edge_mask
        return d


# ------------------------------------------------------------ caption
class Caption(nn.Module):
    """The two-GRU top-down decoder with attention over each target's
    local proposals."""

    def __init__(self, num_vocabs, emb_size, hidden_size, num_locals,
                 max_des_len, min_iou, feat_size=128):
        super().__init__()
        self.num_vocabs, self.hidden_size = num_vocabs, hidden_size
        self.num_locals, self.max_des_len = num_locals, max_des_len
        self.min_iou = min_iou
        H = hidden_size
        self.map_topdown = Linear(emb_size + H + feat_size, emb_size)
        self.recurrent_cell_1 = GRUCell(emb_size, H)
        self.map_feat = Linear(feat_size, H, bias=False)
        self.map_hidd = Linear(H, H, bias=False)
        self.attend = Linear(H, 1, bias=False)
        self.map_lang = Linear(feat_size + H, emb_size)
        self.recurrent_cell_2 = GRUCell(emb_size, H)
        self.classifier = Linear(H, num_vocabs)

    def teacher_forced(self, d):
        """One target per sample, the argmax-IoU proposal against the
        reference box, decoded over ``max_des_len + 1`` steps from the
        caption's embeddings."""
        d = dict(d)
        word_embs = d["lang_feat"]
        obj_feats = d["bbox_feature"]
        masks = d["bbox_mask"].float()
        B, K, _ = obj_feats.shape
        rows = torch.arange(B, device=obj_feats.device)
        corners = d["bbox_corner"].detach()
        ious = ops.box3d_iou_batch(corners,
                                   d["ref_box_corner_label"][:, None])
        tid = torch.argmax(ious, dim=1)
        target_ious = ious[rows, tid]
        target_feat = obj_feats[rows, tid]
        centers = bbox_centers(corners)
        dist = norm3(centers[rows, tid][:, None] - centers)
        t_corners = corners[rows, tid][:, None]
        iou = ops.box3d_iou_batch(t_corners.expand_as(corners), corners)
        self_mask = torch.arange(K, device=corners.device)[None] == tid[:, None]
        topk = topk_locals(dist, masks == 0, iou, self_mask, self.num_locals,
                           include_self=True)
        valid = torch.zeros((B, K), dtype=torch.float32,
                            device=corners.device).scatter_(1, topk, 1.0)
        rel = d["edge_feature"][rows, tid]
        nbr = d["edge_nbr_idx"][rows, tid].long()
        C = obj_feats.shape[-1]
        obj_feats = obj_feats + torch.zeros_like(obj_feats).scatter(
            1, nbr[..., None].expand(-1, -1, C), rel)
        mapped = self.map_feat(obj_feats)
        h1 = target_feat.new_zeros((B, self.hidden_size))
        h2 = target_feat.new_zeros((B, self.hidden_size))
        neg_mask = torch.where(valid[..., None] == 0, -1e30, 0.0)
        logits = []
        for t in range(self.max_des_len + 1):
            x = torch.relu(self.map_topdown(
                torch.cat([word_embs[:, t], h2, target_feat], dim=-1)))
            h1 = self.recurrent_cell_1(x, h1)
            combined = torch.tanh(mapped + self.map_hidd(h1)[:, None, :])
            attn = torch.softmax(self.attend(combined) + neg_mask, dim=1)
            attended = torch.sum(obj_feats * attn, dim=1)
            h2 = self.recurrent_cell_2(torch.relu(self.map_lang(
                torch.cat([attended, h1], dim=-1))), h2)
            logits.append(self.classifier(h2))
        good = target_ious > self.min_iou
        num_good = torch.sum(good)
        d["lang_cap"] = torch.stack(logits, dim=1)
        d["good_bbox_masks"] = good
        d["pred_ious"] = torch.where(
            num_good > 0,
            torch.sum(target_ious * good) / torch.clamp(num_good, min=1),
            torch.zeros_like(target_ious[0]))
        return d

    def forced_scene(self, d, forced, read):
        """The scene decode of every proposal over its ``num_locals``
        local slots, each step fed the embedding of ``forced`` (B, K, T).
        Returns the widest gap by which the logit of a ``read`` token lies
        below the step's best, and the argmax tokens (B, K, T)."""
        emb_table = d["glove_emb_table"]
        obj_feats = d["bbox_feature"]
        B, K, _ = obj_feats.shape
        _, loc = locals_all(d["bbox_corner"], d["bbox_mask"].float(),
                            self.num_locals, include_self=True)
        shared = self.map_feat(obj_feats)
        base = gather_slots(shared, loc)
        ctx = gather_slots(obj_feats, loc)
        match = (loc[:, :, :, None].long()
                 == d["edge_nbr_idx"][:, :, None, :].long()).float()
        base = base + ops.einsum("btlj,btjh->btlh", match,
                                 self.map_feat(d["edge_feature"]))
        ctx = ctx + ops.einsum("btlj,btjc->btlc", match, d["edge_feature"])
        w = self.attend.weight[0]
        h1 = obj_feats.new_zeros((B, K, self.hidden_size))
        h2 = obj_feats.new_zeros((B, K, self.hidden_size))
        prev = d["lang_feat"][:, 0][:, None].expand(B, K, -1)
        gap = torch.zeros((), device=obj_feats.device)
        picks = []
        for t in range(forced.shape[-1]):
            x = torch.relu(self.map_topdown(torch.cat([prev, h2, obj_feats],
                                                      -1)))
            h1 = self.recurrent_cell_1(x, h1)
            hproj = self.map_hidd(h1)
            scores = torch.sum(torch.tanh(base + hproj[:, :, None]) * w, -1)
            attn = torch.softmax(scores, dim=-1)
            attended = ops.einsum("btl,btlc->btc", attn, ctx)
            h2 = self.recurrent_cell_2(torch.relu(self.map_lang(
                torch.cat([attended, h1], -1))), h2)
            logits = self.classifier(h2)
            best, pick = logits.max(dim=-1)
            at = torch.gather(logits, -1, read[..., t:t + 1].long())[..., 0]
            gap = torch.maximum(gap, (best - at).max())
            picks.append(pick)
            prev = emb_table[forced[..., t].long()]
        return gap, torch.stack(picks, dim=-1)


class CapNet(nn.Module):
    def __init__(self, cfg: dict, num_vocabs: int):
        super().__init__()
        self.cfg = cfg
        in_dim = (int(cfg["use_height"]) + 3 * int(cfg["use_normal"])
                  + 128 * int(cfg["use_multiview"]))
        self.backbone_net = Backbone(in_dim, cfg["sa_npoints"])
        self.vgen = Voting()
        self.proposal = Proposal(cfg["num_proposals"], 0.3, 16)
        self.graph = Graph(cfg["num_graph_steps"], cfg["num_locals"],
                           cfg["num_bins"])
        self.caption = Caption(num_vocabs, cfg["emb_size"],
                               cfg["hidden_size"], cfg["num_locals"],
                               cfg["max_des_len"], cfg["min_iou"])

    def detect(self, d, train=False, m=0.1):
        d = self.backbone_net(d, train, m)
        d["vote_xyz"], vote_feat = self.vgen(d["seed_xyz"],
                                             d["seed_features"], train, m)
        d = self.proposal(d["vote_xyz"], vote_feat, d, train, m)
        return self.graph(d)

    def forward(self, d, train=True, m=0.1):
        return self.caption.teacher_forced(self.detect(d, train, m))


class MaskVoteNet(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        in_dim = (int(cfg["use_height"]) + 3 * int(cfg["use_normal"])
                  + 128 * int(cfg["use_multiview"]) + 1)
        self.backbone_net = Backbone(in_dim, cfg["sa_npoints"])
        self.vgen = Voting()
        self.proposal = Proposal(cfg["num_proposals"], 5.0, 512, single=True)

    def forward(self, d, train=True, m=0.1):
        d = self.backbone_net(d, train, m)
        d["vote_xyz"], vote_feat = self.vgen(d["seed_xyz"],
                                             d["seed_features"], train, m)
        return self.proposal(d["vote_xyz"], vote_feat, d, train, m)

