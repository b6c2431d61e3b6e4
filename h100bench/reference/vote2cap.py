"""The reference Vote2Cap-DETR: 3DETR-m's masked encoder and set-prediction
decoder with vote queries, Hungarian matching and a GPT-2 caption head, in
plain ``torch`` and ``scipy``, float32.

Written from the papers and the 3DETR code (facebookresearch/3detr
``models/model_3detr.py``, ``models/transformer.py``, ``criterion.py``),
not from the port: the plain FPS, ball query and gathers of
``reference.ops``; attention as a dense ``softmax(Q K^T / sqrt(d) +
mask) V``; every product through ``ops.linear``, ``ops.matmul`` or
``ops.einsum``, so that ``ops.precision("tf32")`` rounds them all; its
own costs and ``linear_sum_assignment``.  Module and parameter names are
the port's, so one state dict loads into both.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from h100bench.reference import losses, ops
from h100bench.reference.model import Linear, SharedMLP


def dense_attention(q, k, v, keep=None, causal=False):
    """q (B, H, Nq, D), k and v (B, H, Nk, D), ``keep`` (B, 1, Nq, Nk)
    bool, True where a pair takes part."""
    scores = ops.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if causal:
        n = q.shape[2]
        keep = torch.ones((n, n), dtype=torch.bool, device=q.device).tril()
    if keep is not None:
        scores = scores.masked_fill(~keep, float("-inf"))
    return ops.matmul(torch.softmax(scores, -1), v)


def distances(xyz):
    """(B, N, 3) -> (B, N, N): sqrt((dx*dx + dy*dy) + dz*dz)."""
    x = xyz.detach()
    dx, dy, dz = (x[:, :, None, i] - x[:, None, :, i] for i in range(3))
    return torch.sqrt(dx * dx + dy * dy + dz * dz)


class Attention(nn.Module):
    def __init__(self, dim, nhead):
        super().__init__()
        self.nhead = nhead
        self.q, self.k = Linear(dim, dim), Linear(dim, dim)
        self.v, self.o = Linear(dim, dim), Linear(dim, dim)

    def forward(self, query, key, value, keep=None, causal=False):
        B, Nq, C = query.shape
        Nk, H = key.shape[1], self.nhead

        def split(x, n):
            return x.reshape(B, n, H, C // H).permute(0, 2, 1, 3)

        out = dense_attention(split(self.q(query), Nq), split(self.k(key), Nk),
                              split(self.v(value), Nk), keep, causal)
        return self.o(out.permute(0, 2, 1, 3).reshape(B, Nq, C))


class LayerNorm(nn.Module):
    def __init__(self, dim, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return F.layer_norm(x, x.shape[-1:], self.weight, self.bias, self.eps)


class EncoderLayer(nn.Module):
    def __init__(self, dim, nhead, ffn):
        super().__init__()
        self.self_attn = Attention(dim, nhead)
        self.norm1, self.norm2 = LayerNorm(dim), LayerNorm(dim)
        self.linear1, self.linear2 = Linear(dim, ffn), Linear(ffn, dim)

    def forward(self, x, keep):
        h = self.norm1(x)
        x = x + self.self_attn(h, h, h, keep)
        return x + self.linear2(torch.relu(self.linear1(self.norm2(x))))


class DecoderLayer(nn.Module):
    def __init__(self, dim, nhead, ffn):
        super().__init__()
        self.self_attn = Attention(dim, nhead)
        self.cross_attn = Attention(dim, nhead)
        self.norm1, self.norm2, self.norm3 = (LayerNorm(dim), LayerNorm(dim),
                                              LayerNorm(dim))
        self.linear1, self.linear2 = Linear(dim, ffn), Linear(ffn, dim)

    def forward(self, tgt, memory, query_pos, pos):
        h = self.norm1(tgt)
        q = h + query_pos
        tgt = tgt + self.self_attn(q, q, h)
        h = self.norm2(tgt)
        tgt = tgt + self.cross_attn(h + query_pos, memory + pos, memory)
        return tgt + self.linear2(torch.relu(self.linear1(self.norm3(tgt))))


class GPT2Block(nn.Module):
    def __init__(self, dim, nhead, mlp):
        super().__init__()
        self.ln_1, self.ln_cross_attn, self.ln_2 = (LayerNorm(dim),
                                                    LayerNorm(dim),
                                                    LayerNorm(dim))
        self.attn = Attention(dim, nhead)
        self.cross_attn = Attention(dim, nhead)
        self.c_fc, self.c_proj = Linear(dim, mlp), Linear(mlp, dim)

    def forward(self, x, context):
        h = self.ln_1(x)
        x = x + self.attn(h, h, h, causal=True)
        x = x + self.cross_attn(self.ln_cross_attn(x), context, context)
        h = self.c_fc(self.ln_2(x))
        g = 0.5 * h * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                        * (h + 0.044715 * h ** 3)))
        return x + self.c_proj(g)


class SetAbstraction(nn.Module):
    """FPS (or the given picks), first-k ball query, and a PointNet over
    each group of normalised offsets and features; layer 0 over the
    source points before the gather where the input is wider than it."""

    def __init__(self, npoint, radius, nsample, in_features, mlp):
        super().__init__()
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.lean = in_features + 3 > mlp[0]
        self.mlp = SharedMLP(in_features + 3, mlp)

    def forward(self, xyz, features, inds=None, train=False, m=0.1):
        if inds is None:
            inds = ops.furthest_point_sample(xyz, self.npoint)
        new_xyz = ops.gather_points(xyz, inds)
        idx = ops.ball_query(xyz, new_xyz, self.radius, self.nsample)
        if self.lean:
            scale = 1.0 / self.radius
            cat = torch.cat([xyz * scale, features], -1)
            ct_in = new_xyz * scale
            ct_in = torch.cat([ct_in, ct_in.new_zeros(
                ct_in.shape[:-1] + (features.shape[-1],))], -1)
            g = (ops.group_points(self.mlp.dense_0(cat), idx)
                 - self.mlp.dense_0(ct_in)[:, :, None, :])
            out = self.mlp.from_first(g, train, m)
        else:
            rel = (ops.group_points(xyz, idx) - new_xyz[:, :, None, :]) \
                / self.radius
            grouped = torch.cat([rel, ops.group_points(features, idx)], -1)
            out = self.mlp(grouped, train, m)
        return new_xyz, out.amax(dim=2), inds


class Head(nn.Module):
    def __init__(self, dim, hidden, out):
        super().__init__()
        self.mlp = SharedMLP(dim, (hidden, hidden))
        self.out = Linear(hidden, out)

    def forward(self, x, train=False, m=0.1):
        return self.out(self.mlp(x, train, m))


class FourierEmbedding(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.register_buffer("weight", torch.zeros(3, dim // 2))

    def forward(self, xyz, lo, hi):
        x = (xyz - lo[:, None]) / (hi - lo)[:, None] * (2 * math.pi)
        p = ops.matmul(x, self.weight)
        return torch.cat([torch.sin(p), torch.cos(p)], -1)


class CaptionHead(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        dec, dim = cfg["dec_dim"], cfg["cap_dim"]
        self.prefix, self.context = Linear(dec, dim), Linear(dec, dim)
        self.wte = nn.Embedding(cfg["num_vocabs"], dim)
        self.wpe = nn.Embedding(cfg["cap_positions"], dim)
        self.blocks = nn.ModuleList(
            GPT2Block(dim, cfg["cap_nhead"], cfg["cap_mlp_dim"])
            for _ in range(cfg["cap_nlayers"]))
        self.ln_f = LayerNorm(dim)

    def forward(self, query, context, ids):
        T = ids.shape[1]
        words = F.embedding(ids[:, :T - 1].long(), self.wte.weight)
        x = torch.cat([self.prefix(query)[:, None], words], 1)
        x = x + self.wpe.weight[:T]
        ctx = self.context(context)
        for block in self.blocks:
            x = block(x, ctx)
        return ops.linear(self.ln_f(x)[:, 1:], self.wte.weight)


def giou(c1, s1, c2, s2):
    """All-pairs generalized IoU of axis-aligned boxes, (..., N, 3) and
    (..., M, 3) centres and sizes -> (..., N, M)."""
    a_lo, a_hi = c1 - s1 / 2, c1 + s1 / 2
    b_lo, b_hi = c2 - s2 / 2, c2 + s2 / 2
    lo = torch.maximum(a_lo[..., :, None, :], b_lo[..., None, :, :])
    hi = torch.minimum(a_hi[..., :, None, :], b_hi[..., None, :, :])
    inter = torch.prod(torch.clamp(hi - lo, min=0.0), dim=-1)
    va = torch.prod(a_hi - a_lo, dim=-1)
    vb = torch.prod(b_hi - b_lo, dim=-1)
    union = va[..., :, None] + vb[..., None, :] - inter
    enc = torch.prod(torch.maximum(a_hi[..., :, None, :], b_hi[..., None, :, :])
                     - torch.minimum(a_lo[..., :, None, :],
                                     b_lo[..., None, :, :]), dim=-1)
    return inter / (union + 1e-8) - (enc - union) / (enc + 1e-8)


def gt_boxes(d):
    mean = torch.tensor(ops.MEAN_SIZE, dtype=torch.float32,
                        device=d["center_label"].device)
    size = mean[d["size_class_label"].long()] + d["size_residual_label"]
    return (d["sem_cls_label"].long(), d["center_label"][..., :3], size,
            d["box_label_mask"])


@torch.no_grad()
def match(d, cls_cost, giou_cost):
    """Each layer's and scene's Hungarian assignment: (L, B, Q) int64, -1
    for an unmatched query."""
    from scipy.optimize import linear_sum_assignment
    gt_cls, gt_center, gt_size, gt_mask = gt_boxes(d)
    prob = torch.softmax(d["sem_cls_logits"], -1)[..., :-1]
    L, B, Q, _ = prob.shape
    out = np.full((L, B, Q), -1, dtype=np.int64)
    counts = gt_mask.sum(1).long().tolist()
    for layer in range(L):
        for b in range(B):
            n = counts[b]
            if not n:
                continue
            p = prob[layer, b][:, gt_cls[b, :n]]
            g = giou(d["center"][layer, b], d["size"][layer, b],
                     gt_center[b, :n], gt_size[b, :n])
            cost = (cls_cost * -p + giou_cost * -g).double().cpu().numpy()
            rows, cols = linear_sum_assignment(cost)
            out[layer, b, rows] = cols
    return torch.from_numpy(out).to(prob.device)


class Vote2Cap(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        n_pre, n_enc, n_query = cfg["sa_npoints"][:3]
        in_dim = 3 * int(cfg["use_color"]) + 3 * int(cfg["use_normal"])
        enc, dec = cfg["enc_dim"], cfg["dec_dim"]
        self.pre_encoder = SetAbstraction(n_pre, cfg["preenc_radius"],
                                          cfg["preenc_nsample"], in_dim,
                                          cfg["preenc_mlp"])
        self.encoder_layers = nn.ModuleList(
            EncoderLayer(enc, cfg["enc_nhead"], cfg["enc_ffn_dim"])
            for _ in cfg["masking_radius"])
        self.interim = SetAbstraction(n_enc, cfg["interim_radius"],
                                      cfg["interim_nsample"], enc,
                                      cfg["interim_mlp"])
        self.enc_to_dec = SharedMLP(enc, (dec, dec))
        self.vote_fc1, self.vote_fc2 = Linear(dec, dec), Linear(dec, 3)
        self.query_sa = SetAbstraction(n_query, cfg["query_radius"],
                                       cfg["query_nsample"], dec,
                                       cfg["query_mlp"])
        self.pos_embedding = FourierEmbedding(cfg["pos_dim"])
        self.query_proj_1 = Linear(cfg["pos_dim"], dec)
        self.query_proj_2 = Linear(dec, dec)
        self.decoder_layers = nn.ModuleList(
            DecoderLayer(dec, cfg["dec_nhead"], cfg["dec_ffn_dim"])
            for _ in range(cfg["dec_nlayers"]))
        self.decoder_norm = LayerNorm(dec)
        hid = cfg["mlp_dim"]
        self.sem_cls_head = Head(dec, hid, cfg["num_class"] + 1)
        self.center_head = Head(dec, hid, 3)
        self.size_head = Head(dec, hid, 3)
        self.angle_cls_head = Head(dec, hid, cfg["num_angle_bin"])
        self.angle_reg_head = Head(dec, hid, cfg["num_angle_bin"])
        self.caption = CaptionHead(cfg)

    def forward(self, d, train=True, m=0.1):
        cfg = self.cfg
        d = dict(d)
        pc = d["point_clouds"]
        xyz, feats = pc[..., :3].contiguous(), pc[..., 3:]
        lo, hi = xyz.amin(1), xyz.amax(1)
        pos, x, inds = self.pre_encoder(xyz, feats, None, train, m)
        inds = inds.long()
        dist = distances(pos)
        for i, layer in enumerate(self.encoder_layers):
            if i == 1:
                pos, x, picks = self.interim(pos, x, None, train, m)
                inds = torch.gather(inds, 1, picks.long())
                dist = distances(pos)
            x = layer(x, (dist < cfg["masking_radius"][i])[:, None])
        enc_xyz, enc = pos, self.enc_to_dec(x, train, m)

        vote_xyz = enc_xyz + self.vote_fc2(torch.relu(self.vote_fc1(enc)))
        picks = ops.furthest_point_sample(enc_xyz, cfg["sa_npoints"][2])
        query_xyz, tgt, _ = self.query_sa(vote_xyz, enc, picks, train, m)
        query_pos = torch.relu(self.query_proj_2(torch.relu(
            self.query_proj_1(self.pos_embedding(query_xyz, lo, hi)))))
        enc_pos = self.pos_embedding(enc_xyz, lo, hi)
        outs = []
        for layer in self.decoder_layers:
            tgt = layer(tgt, enc, query_pos, enc_pos)
            outs.append(self.decoder_norm(tgt))
        h = torch.stack(outs)
        scale = (hi - lo)[None, :, None]
        center = query_xyz + torch.sigmoid(self.center_head(h, train, m)) - 0.5
        size_n = torch.sigmoid(self.size_head(h, train, m))
        d.update(seed_xyz=enc_xyz, seed_inds=inds, vote_xyz=vote_xyz,
                 scene_lo=lo, scene_hi=hi, features=h,
                 sem_cls_logits=self.sem_cls_head(h, train, m),
                 center=center,
                 center_normalized=(center - lo[None, :, None]) / scale,
                 size_normalized=size_n, size=size_n * scale,
                 angle_logits=self.angle_cls_head(h, train, m),
                 angle_residual=self.angle_reg_head(h, train, m))
        d["assignment"] = match(d, cfg["matcher_cls_cost"],
                                cfg["matcher_giou_cost"])
        last = d["assignment"][-1]
        b, q = torch.nonzero(last >= 0, as_tuple=True)
        g = last[b, q]
        feat = h[-1]
        near_d = distances(center[-1])
        near_d = near_d.masked_fill(torch.eye(near_d.shape[1], dtype=torch.bool,
                                              device=near_d.device),
                                    float("inf"))
        near = torch.argsort(near_d, dim=-1, stable=True)[..., :cfg["cap_knn"]]
        ids = d["object_lang_ids"][b, g]
        d["cap_logits"] = self.caption(feat[b, q], feat[b[:, None], near[b, q]],
                                       ids)
        d["cap_target"] = ids[:, 1:]
        return d


def loss(d, cfg):
    """3DETR's set criterion summed over the layers, the vote loss and the
    captions' token-mean cross entropy.  Every GT angle is bin 0 with
    residual 0 (ScanNet's boxes are axis-aligned): the angle class's
    cross entropy over one bin is 0 and left out."""
    gt_cls, gt_center, gt_size, gt_mask = gt_boxes(d)
    lo, hi = d["scene_lo"], d["scene_hi"]
    scale = (hi - lo)[:, None]
    center_n, size_n = (gt_center - lo[:, None]) / scale, gt_size / scale
    a = d["assignment"]
    L = a.shape[0]
    nbox = torch.clamp(gt_mask.sum(), min=1.0)
    noobj = cfg["num_class"]
    total = 0.0
    for layer in range(L):
        matched = a[layer] >= 0
        g = a[layer].clamp(min=0)
        target = torch.where(matched, torch.gather(gt_cls, 1, g), noobj)
        w = torch.where(target == noobj, cfg["noobj_weight"], 1.0)
        cls = (torch.sum(ops.ce_logits(d["sem_cls_logits"][layer], target) * w)
               / torch.sum(w))
        gc = ops.take_rows(center_n, g)
        gs = ops.take_rows(size_n, g)
        center = torch.sum(torch.abs(d["center_normalized"][layer] - gc).sum(-1)
                           * matched) / nbox
        size = torch.sum(torch.abs(d["size_normalized"][layer] - gs).sum(-1)
                         * matched) / nbox
        angle = torch.sum(ops.huber_loss(d["angle_residual"][layer][..., 0])
                          * matched) / nbox
        total = total + (cls + cfg["loss_center_weight"] * center
                         + cfg["loss_size_weight"] * size
                         + cfg["loss_angle_reg_weight"] * angle)
    target = d["cap_target"].long()
    mask = (target != 0).float()
    cap = (torch.sum(ops.ce_logits(d["cap_logits"], target) * mask)
           / torch.clamp(mask.sum(), min=1.0))
    return (total + cfg["loss_vote_weight"] * losses.vote_loss(d)
            + cfg["loss_caption_weight"] * cap)
