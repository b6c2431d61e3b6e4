"""Transformer layers of Vote2Cap-DETR: 3DETR's pre-LN encoder and decoder
layers (facebookresearch/3detr ``models/transformer.py``), its Fourier
position embedding (``models/position_embedding.py``) and the GPT-2 block
of the caption head.

Every projection is its own ``nn.Linear`` (q, k, v and the output), never
a fused ``in_proj_weight``, so every learned matrix is a 2-D ``.weight``.
Attention is ``scaled_dot_product_attention`` with dropout off: on the
card, float32 with a mask runs the memory-efficient kernel.  A mask is
boolean, True where a pair takes part, one per scene broadcast over the
heads.  While a profiler runs, every call is recorded in
``utils.profiling.ATTENTION_RECORD``; a masked call's kept pairs are
counted on the device and never read inside the step.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from scan2cap_torch.utils.profiling import (ATTENTION_RECORD, AttentionEntry,
                                            profiling)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              keep: Optional[torch.Tensor] = None,
              causal: bool = False) -> torch.Tensor:
    """q (B, H, Nq, D), k and v (B, H, Nk, D); ``keep`` (B, 1, Nq, Nk)
    bool -> (B, H, Nq, D)."""
    if profiling():
        B, H, Nq, D = q.shape
        ATTENTION_RECORD.append(AttentionEntry(
            B, H, Nq, k.shape[2], D, causal,
            torch.is_grad_enabled() and q.requires_grad,
            None if keep is None else keep.sum(),
            0 if keep is None else keep.numel() * keep.element_size()))
    return F.scaled_dot_product_attention(q, k, v, attn_mask=keep,
                                          dropout_p=0.0, is_causal=causal)


def pair_distances(xyz: torch.Tensor) -> torch.Tensor:
    """(B, N, 3) -> (B, N, N) Euclidean distances, each the square root
    of (dx*dx + dy*dy) + dz*dz in that order (3DETR's ``cdist``)."""
    x = xyz.detach()
    d = [x[:, :, None, i] - x[:, None, :, i] for i in range(3)]
    return torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])


class MultiheadAttention(nn.Module):
    """Attention with separate q, k, v and output projections (biases as
    ``nn.MultiheadAttention``'s)."""

    def __init__(self, dim: int, nhead: int):
        super().__init__()
        self.nhead = nhead
        self.q = nn.Linear(dim, dim)
        self.k = nn.Linear(dim, dim)
        self.v = nn.Linear(dim, dim)
        self.o = nn.Linear(dim, dim)

    def forward(self, query, key, value, keep=None, causal=False):
        B, Nq, C = query.shape
        Nk, H = key.shape[1], self.nhead

        def heads(x, n):
            return x.view(B, n, H, C // H).transpose(1, 2)

        out = attention(heads(self.q(query), Nq), heads(self.k(key), Nk),
                        heads(self.v(value), Nk), keep, causal)
        return self.o(out.transpose(1, 2).reshape(B, Nq, C))


class EncoderLayer(nn.Module):
    """3DETR's ``TransformerEncoderLayer.forward_pre`` (ReLU, no position
    embedding in the masked encoder)."""

    def __init__(self, dim: int, nhead: int, ffn_dim: int):
        super().__init__()
        self.self_attn = MultiheadAttention(dim, nhead)
        self.norm1 = nn.LayerNorm(dim)
        self.norm2 = nn.LayerNorm(dim)
        self.linear1 = nn.Linear(dim, ffn_dim)
        self.linear2 = nn.Linear(ffn_dim, dim)

    def forward(self, x: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
        h = self.norm1(x)
        x = x + self.self_attn(h, h, h, keep)
        return x + self.linear2(torch.relu(self.linear1(self.norm2(x))))


class DecoderLayer(nn.Module):
    """3DETR's ``TransformerDecoderLayer.forward_pre``: self-attention of
    the queries, cross-attention to the encoder tokens with their position
    embeddings added to the keys, a ReLU FFN."""

    def __init__(self, dim: int, nhead: int, ffn_dim: int):
        super().__init__()
        self.self_attn = MultiheadAttention(dim, nhead)
        self.cross_attn = MultiheadAttention(dim, nhead)
        self.norm1 = nn.LayerNorm(dim)
        self.norm2 = nn.LayerNorm(dim)
        self.norm3 = nn.LayerNorm(dim)
        self.linear1 = nn.Linear(dim, ffn_dim)
        self.linear2 = nn.Linear(ffn_dim, dim)

    def forward(self, tgt, memory, query_pos, pos):
        h = self.norm1(tgt)
        q = h + query_pos
        tgt = tgt + self.self_attn(q, q, h)
        h = self.norm2(tgt)
        tgt = tgt + self.cross_attn(h + query_pos, memory + pos, memory)
        return tgt + self.linear2(torch.relu(self.linear1(self.norm3(tgt))))


class FourierEmbedding(nn.Module):
    """3DETR's ``PositionEmbeddingCoordsSine(pos_type="fourier")``: xyz
    scaled into [0, 1] by the scene's range, times 2 pi, through a fixed
    Gaussian matrix ``weight`` (3, dim / 2), then [sin, cos].  The matrix
    is a buffer: it does not learn."""

    def __init__(self, dim: int, scale: float = 1.0):
        super().__init__()
        self.register_buffer("weight", torch.randn(3, dim // 2) * scale)

    def forward(self, xyz, lo, hi):
        x = (xyz - lo[:, None]) / (hi - lo)[:, None] * (2 * math.pi)
        p = torch.matmul(x, self.weight)
        return torch.cat([torch.sin(p), torch.cos(p)], -1)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


class GPT2Block(nn.Module):
    """GPT-2's block with cross-attention (``ln_1``, causal
    self-attention, ``ln_cross_attn``, cross-attention, ``ln_2``, a
    tanh-GELU MLP), residual around each."""

    def __init__(self, dim: int, nhead: int, mlp_dim: int):
        super().__init__()
        self.ln_1 = nn.LayerNorm(dim)
        self.attn = MultiheadAttention(dim, nhead)
        self.ln_cross_attn = nn.LayerNorm(dim)
        self.cross_attn = MultiheadAttention(dim, nhead)
        self.ln_2 = nn.LayerNorm(dim)
        self.c_fc = nn.Linear(dim, mlp_dim)
        self.c_proj = nn.Linear(mlp_dim, dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        h = self.ln_1(x)
        x = x + self.attn(h, h, h, causal=True)
        x = x + self.cross_attn(self.ln_cross_attn(x), context, context)
        return x + self.c_proj(gelu_tanh(self.c_fc(self.ln_2(x))))
