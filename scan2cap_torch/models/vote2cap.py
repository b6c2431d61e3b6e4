"""Vote2Cap-DETR (Chen et al., CVPR 2023, github.com/ch3cook-fdu/
Vote2Cap-DETR) on 3DETR-m (Misra et al., ICCV 2021,
github.com/facebookresearch/3detr ``models/model_3detr.py``).

* Pre-encoder: one set abstraction (FPS ``sa_npoints[0]`` of the cloud,
  radius 0.2, 64 samples, MLP [3 + C, 64, 128, 256]) over xyz and the
  input columns.
* Masked encoder: 3 pre-LN layers; layer i masks the pairs at a distance
  of at least ``masking_radius[i]``; after layer 0 an interim set
  abstraction (FPS ``sa_npoints[1]``, radius 0.4, 32 samples) halves the
  tokens.  Then ``encoder_to_decoder_projection`` (two Linear + BN +
  ReLU).
* Vote queries: an FFN votes an offset per token; FPS picks
  ``sa_npoints[2]`` tokens, whose votes are the query positions; a set
  abstraction over the votes (radius 0.3, 16 samples) gathers the query
  content.
* Decoder: 8 pre-LN layers, queries with projected Fourier embeddings of
  their xyz, cross-attention to the tokens with their own embeddings on
  the keys; every layer's output through one final LayerNorm, and one set
  of heads shared by all layers (class with no-object, centre offset,
  size, one angle bin).
* Matching: every layer's Hungarian assignment (``ops/matching.py``).
* Caption head: a 2-layer GPT-2 stack (the dual-clued captioner) over the
  queries the last layer matched: the projected query as a one-token
  prefix, cross-attention to its ``cap_knn`` nearest other queries by
  predicted centre, teacher-forced on the matched GT object's caption,
  the LM head tied to the word embedding.

Spans: ``scan2cap.encoder`` (pre-encoder, encoder, projection),
``scan2cap.detr_decoder`` (vote queries, decoder and heads),
``scan2cap.match``, ``scan2cap.decode`` (the caption head).  Dropout is
left out everywhere.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from scan2cap_torch.config import (ModelConfig, SCANNET_MEAN_SIZE_ARR,
                                   Vote2CapConfig)
from scan2cap_torch.device import resolve_device
from scan2cap_torch.models.backbone import PointnetSAModuleVotes
from scan2cap_torch.models.layers import SharedMLP, seeded_init
from scan2cap_torch.models.transformer import (DecoderLayer, EncoderLayer,
                                               FourierEmbedding, GPT2Block,
                                               pair_distances)
from scan2cap_torch.ops import furthest_point_sample
from scan2cap_torch.ops.matching import hungarian
from scan2cap_torch.utils.profiling import annotate


class Head(nn.Module):
    """3DETR's box head: two Linear + BN + ReLU, then a Linear."""

    def __init__(self, dim: int, hidden: int, out: int):
        super().__init__()
        self.mlp = SharedMLP(dim, (hidden, hidden))
        self.out = nn.Linear(hidden, out)

    def forward(self, x, train=False, bn_momentum=0.1):
        return self.out(self.mlp(x, train, bn_momentum))


class CaptionHead(nn.Module):
    """The GPT-2 captioner: ``prefix`` and ``context`` project the query
    and its neighbours; ``wte`` is the word embedding and the LM head."""

    def __init__(self, dec_dim: int, v: Vote2CapConfig):
        super().__init__()
        self.prefix = nn.Linear(dec_dim, v.cap_dim)
        self.context = nn.Linear(dec_dim, v.cap_dim)
        self.wte = nn.Embedding(v.num_vocabs, v.cap_dim)
        self.wpe = nn.Embedding(v.cap_positions, v.cap_dim)
        self.blocks = nn.ModuleList(
            GPT2Block(v.cap_dim, v.cap_nhead, v.cap_mlp_dim)
            for _ in range(v.cap_nlayers))
        self.ln_f = nn.LayerNorm(v.cap_dim)

    def forward(self, query, context, ids):
        """query (N, C), context (N, k, C), ids (N, T) -> logits
        (N, T - 1, V) of ids[:, 1:]: position 0 is the prefix, position t
        holds ids[t - 1]."""
        T = ids.shape[1]
        x = torch.cat([self.prefix(query)[:, None],
                       self.wte(ids[:, :T - 1].long())], 1)
        x = x + self.wpe.weight[:T]
        ctx = self.context(context)
        for block in self.blocks:
            x = block(x, ctx)
        return F.linear(self.ln_f(x)[:, 1:], self.wte.weight)


def scene_range(xyz: torch.Tensor):
    """Each scene's (min, max) corner of its points, (B, 3) each."""
    x = xyz.detach()
    return x.amin(1), x.amax(1)


def gt_boxes(batch: dict, mean_size: torch.Tensor):
    """GT classes (B, M), centres and sizes (B, M, 3), real-box mask."""
    cls = batch["size_class_label"].long()
    size = mean_size[cls] + batch["size_residual_label"]
    return (batch["sem_cls_label"], batch["center_label"][..., :3], size,
            batch["box_label_mask"])


class Vote2CapDETR(nn.Module):
    def __init__(self, cfg: ModelConfig, vcfg: Vote2CapConfig = None,
                 device: str | torch.device = "cuda", seed: int = 0):
        """``cfg`` gives the point counts, classes and input columns,
        ``vcfg`` the rest; seeded random weights on ``device``."""
        super().__init__()
        v = vcfg or Vote2CapConfig()
        dev = resolve_device(device)
        self.cfg, self.vcfg = cfg, v
        n_pre, n_enc, n_query = cfg.sa_npoints[:3]
        self.pre_encoder = PointnetSAModuleVotes(
            n_pre, v.preenc_radius, v.preenc_nsample, cfg.input_feature_dim,
            v.preenc_mlp)
        self.encoder_layers = nn.ModuleList(
            EncoderLayer(v.enc_dim, v.enc_nhead, v.enc_ffn_dim)
            for _ in range(len(v.masking_radius)))
        self.interim = PointnetSAModuleVotes(
            n_enc, v.interim_radius, v.interim_nsample, v.enc_dim,
            v.interim_mlp)
        self.enc_to_dec = SharedMLP(v.enc_dim, (v.dec_dim, v.dec_dim))
        self.vote_fc1 = nn.Linear(v.dec_dim, v.dec_dim)
        self.vote_fc2 = nn.Linear(v.dec_dim, 3)
        self.query_sa = PointnetSAModuleVotes(
            n_query, v.query_radius, v.query_nsample, v.dec_dim, v.query_mlp)
        self.pos_embedding = FourierEmbedding(v.pos_dim, v.gauss_scale)
        self.query_proj_1 = nn.Linear(v.pos_dim, v.dec_dim)
        self.query_proj_2 = nn.Linear(v.dec_dim, v.dec_dim)
        self.decoder_layers = nn.ModuleList(
            DecoderLayer(v.dec_dim, v.dec_nhead, v.dec_ffn_dim)
            for _ in range(v.dec_nlayers))
        self.decoder_norm = nn.LayerNorm(v.dec_dim)
        self.sem_cls_head = Head(v.dec_dim, v.mlp_dim, cfg.num_class + 1)
        self.center_head = Head(v.dec_dim, v.mlp_dim, 3)
        self.size_head = Head(v.dec_dim, v.mlp_dim, 3)
        self.angle_cls_head = Head(v.dec_dim, v.mlp_dim, v.num_angle_bin)
        self.angle_reg_head = Head(v.dec_dim, v.mlp_dim, v.num_angle_bin)
        self.caption = CaptionHead(v.dec_dim, v)
        self.register_buffer("mean_size", torch.tensor(
            np.asarray(SCANNET_MEAN_SIZE_ARR, np.float32)), persistent=False)
        seeded_init(self, seed)
        self.device = dev
        self.to(dev)
        self.eval()

    def encode(self, xyz, features, train, m):
        v = self.vcfg
        pre_xyz, x, pre_inds = self.pre_encoder(xyz, features, None, train, m)
        pos, dist = pre_xyz, pair_distances(pre_xyz)
        inds = pre_inds.long()
        for i, layer in enumerate(self.encoder_layers):
            if i == 1:
                pos, x, picks = self.interim(pos, x, None, train, m)
                inds = torch.gather(inds, 1, picks.long())
                dist = pair_distances(pos)
            x = layer(x, (dist < v.masking_radius[i])[:, None])
        return pos, self.enc_to_dec(x, train, m), inds

    def decode_boxes(self, enc_xyz, enc_feat, lo, hi, train, m):
        n_query = self.cfg.sa_npoints[2]
        vote_xyz = enc_xyz + self.vote_fc2(torch.relu(self.vote_fc1(enc_feat)))
        picks = furthest_point_sample(enc_xyz, n_query)
        query_xyz, tgt, _ = self.query_sa(vote_xyz, enc_feat, picks, train, m)
        query_pos = torch.relu(self.query_proj_2(torch.relu(
            self.query_proj_1(self.pos_embedding(query_xyz, lo, hi)))))
        enc_pos = self.pos_embedding(enc_xyz, lo, hi)
        outs = []
        for layer in self.decoder_layers:
            tgt = layer(tgt, enc_feat, query_pos, enc_pos)
            outs.append(self.decoder_norm(tgt))
        h = torch.stack(outs)                               # (L, B, Q, C)
        scale = (hi - lo)[None, :, None]
        center = query_xyz + torch.sigmoid(self.center_head(h, train, m)) - 0.5
        size_normalized = torch.sigmoid(self.size_head(h, train, m))
        return dict(
            vote_xyz=vote_xyz, features=h,
            sem_cls_logits=self.sem_cls_head(h, train, m),
            center=center,
            center_normalized=(center - lo[None, :, None]) / scale,
            size_normalized=size_normalized, size=size_normalized * scale,
            angle_logits=self.angle_cls_head(h, train, m),
            angle_residual=self.angle_reg_head(h, train, m))

    def describe(self, d, pairs, batch):
        """Teacher-forced logits of the captions of the matched GT objects:
        ``pairs`` (3, N) scene, query and GT box."""
        b, q, g = pairs
        feats = d["features"][-1]                           # (B, Q, C)
        dist = pair_distances(d["center"][-1])
        Q = dist.shape[1]
        eye = torch.eye(Q, dtype=torch.bool, device=dist.device)
        dist = dist.masked_fill(eye, float("inf"))
        near = torch.argsort(dist, dim=-1, stable=True)[..., :self.vcfg.cap_knn]
        ids = batch["object_lang_ids"][b, g]                # (N, T)
        context = feats[b[:, None], near[b, q]]             # (N, k, C)
        return self.caption(feats[b, q], context, ids), ids[:, 1:]

    def forward(self, batch: dict, train: bool = False,
                bn_momentum: float = 0.1) -> dict:
        v = self.vcfg
        pc = batch["point_clouds"]
        xyz = pc[..., :3].contiguous()
        features = pc[..., 3:] if pc.shape[-1] > 3 else None
        lo, hi = scene_range(xyz)
        with annotate("scan2cap.encoder"):
            enc_xyz, enc_feat, enc_inds = self.encode(xyz, features, train,
                                                      bn_momentum)
        with annotate("scan2cap.detr_decoder"):
            d = self.decode_boxes(enc_xyz, enc_feat, lo, hi, train,
                                  bn_momentum)
        d.update(batch, seed_xyz=enc_xyz, seed_inds=enc_inds,
                 scene_lo=lo, scene_hi=hi)
        gt_cls, gt_center, gt_size, gt_mask = gt_boxes(batch, self.mean_size)
        prob = torch.softmax(d["sem_cls_logits"], -1)[..., :-1]
        d["assignment"], pairs = hungarian(
            prob, d["center"], d["size"], gt_cls, gt_center, gt_size,
            gt_mask, v.matcher_cls_cost, v.matcher_giou_cost)
        with annotate("scan2cap.decode"):
            d["cap_logits"], d["cap_target"] = self.describe(d, pairs, batch)
        return d
