"""Vote2Cap-DETR's floating-point operations in one train step, counted
from the configuration alone, as ``flops.py`` counts CapNet's: every
matrix product at 2 operations a multiply-add (the linear layers, the
attention's two products over every pair, dense as the reference computes
them, the Fourier projection and the tied LM head), and in the backward
the weight's gradient of every product whose output reaches the loss and
the input's gradient where the input needs one.  The angle class head
reaches no loss: forward only.  Captions: ``described_objects`` a scene,
every one matched.  ``h100bench/tests`` hold the count equal to what
``FlopCounterMode`` counts on the reference.
"""

from __future__ import annotations

from typing import Dict

from h100bench.flops import Count


def _fourier(c: Count, rows: int, dim: int, grad_in: bool) -> None:
    """xyz (rows, 3) through the fixed Gaussian matrix (3, dim / 2)."""
    f = 2 * rows * 3 * (dim // 2)
    c.total += f * (2 if c.train and grad_in else 1)


def _attention(c: Count, B: int, H: int, nq: int, nk: int, dim: int,
               q_rows: int, kv_rows: int) -> None:
    """q, k, v and output projections, Q K^T and P V."""
    c.mm(q_rows, dim, dim)
    c.mm(kv_rows, dim, dim)
    c.mm(kv_rows, dim, dim)
    c.mm(q_rows, dim, dim)
    D = dim // H
    c.mm(B * H * nq, D, nk)
    c.mm(B * H * nq, nk, D)


def _sa(c: Count, B: int, N: int, M: int, S: int, width: int, mlp,
        lean: bool, grad_centres: bool) -> None:
    if lean:
        c.mm(B * N, width, mlp[0])
        c.mm(B * M, width, mlp[0], grad_in=grad_centres)
    else:
        c.mm(B * M * S, width, mlp[0], grad_in=False)
    for a, b in zip(mlp, mlp[1:]):
        c.mm(B * M * S, a, b)


def count(c: Count, B: int, cfg: Dict) -> None:
    n_pre, n_enc, Q = cfg["sa_npoints"][:3]
    C = 3 * int(cfg["use_color"]) + 3 * int(cfg["use_normal"])
    E, D = cfg["enc_dim"], cfg["dec_dim"]
    _sa(c, B, cfg["num_points"], n_pre, cfg["preenc_nsample"], C + 3,
        cfg["preenc_mlp"], False, False)
    for i, _ in enumerate(cfg["masking_radius"]):
        if i == 1:
            _sa(c, B, n_pre, n_enc, cfg["interim_nsample"], E + 3,
                cfg["interim_mlp"], True, False)
        n = n_pre if i == 0 else n_enc
        _attention(c, B, cfg["enc_nhead"], n, n, E, B * n, B * n)
        c.mm(B * n, E, cfg["enc_ffn_dim"])
        c.mm(B * n, cfg["enc_ffn_dim"], E)
    c.mm(B * n_enc, E, D)                      # encoder_to_decoder
    c.mm(B * n_enc, D, D)
    c.mm(B * n_enc, D, D)                      # votes
    c.mm(B * n_enc, D, 3)
    _sa(c, B, n_enc, Q, cfg["query_nsample"], D + 3, cfg["query_mlp"], True,
        True)
    _fourier(c, B * Q, cfg["pos_dim"], True)
    _fourier(c, B * n_enc, cfg["pos_dim"], False)
    c.mm(B * Q, cfg["pos_dim"], D)
    c.mm(B * Q, D, D)
    H = cfg["dec_nhead"]
    for _ in range(cfg["dec_nlayers"]):
        _attention(c, B, H, Q, Q, D, B * Q, B * Q)
        _attention(c, B, H, Q, n_enc, D, B * Q, B * n_enc)
        c.mm(B * Q, D, cfg["dec_ffn_dim"])
        c.mm(B * Q, cfg["dec_ffn_dim"], D)
    rows, hid = cfg["dec_nlayers"] * B * Q, cfg["mlp_dim"]
    for out in (cfg["num_class"] + 1, 3, 3, cfg["num_angle_bin"]):
        c.mm(rows, D, hid)
        c.mm(rows, hid, hid)
        c.mm(rows, hid, out)
    c.fixed(rows, D, hid)                      # the angle class head
    c.fixed(rows, hid, hid)
    c.fixed(rows, hid, cfg["num_angle_bin"])
    N, T, k = B * cfg["described_objects"], cfg["max_des_len"] + 2, \
        cfg["cap_knn"]
    W = cfg["cap_dim"]
    c.mm(N, D, W)                              # prefix
    c.mm(N * k, D, W)                          # context
    for _ in range(cfg["cap_nlayers"]):
        _attention(c, N, cfg["cap_nhead"], T, T, W, N * T, N * T)
        _attention(c, N, cfg["cap_nhead"], T, k, W, N * T, N * k)
        c.mm(N * T, W, cfg["cap_mlp_dim"])
        c.mm(N * T, cfg["cap_mlp_dim"], W)
    c.mm(N * (T - 1), W, cfg["num_vocabs"])    # the tied LM head
