"""The 2D caption models (counterpart of ``scan2cap_tpu/twod/models.py``;
reference Scan2Cap-2D/models/{snt,tdbu,retr}.py).

Both decoders run the port's ``models/layers.GRUCell``: teacher-forced for
``max_desc_len + 1`` steps (the logits), greedily for ``max_desc_len - 1``
(the tokens, fed back through the dense GloVe table
``data_dict["glove_emb_table"]``).  Module names follow the Flax tree, so
``convert.state_dict_from_flax`` carries the JAX package's parameters.
``Retrieval2D`` stays host numpy, as in the JAX package, so that its
argmax ties are the same.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from scan2cap_torch.models.layers import GRUCell


def _greedy(step, first: torch.Tensor, emb_table: torch.Tensor,
            num_steps: int):
    """Run ``step(prev) -> (logits, extra)`` greedily: each step's argmax
    token (the first maximum, as ``jnp.argmax``) feeds its embedding to the
    next.  Returns the (N, num_steps) tokens and the extras."""
    prev, tokens, extras = first, [], []
    for _ in range(num_steps):
        logits, extra = step(prev)
        tok = torch.argmax(logits, dim=-1)
        tokens.append(tok)
        extras.append(extra)
        prev = emb_table[tok]
    return torch.stack(tokens, dim=1), extras


class ShowAndTell2D(nn.Module):
    """A GRU decoder seeded by the global (+ target) image feature
    (snt.py:41-170)."""

    def __init__(self, num_vocabs: int, emb_size: int = 300,
                 feat_size: int = 2048, hidden_size: int = 512,
                 max_desc_len: int = 30, add_target: bool = True):
        super().__init__()
        self.max_desc_len = max_desc_len
        self.add_target = add_target
        self.map_feat = nn.Linear(feat_size, hidden_size)
        self.recurrent_cell = GRUCell(emb_size, hidden_size)
        self.classifier = nn.Linear(hidden_size, num_vocabs)

    def forward(self, data_dict: Dict, is_eval: bool = False) -> Dict:
        d = dict(data_dict)
        feat = d["g_feat"]
        if self.add_target:
            feat = torch.cat([feat, d["t_feat"]], dim=-1)
        d["inp_feat"] = feat
        hidden = torch.relu(self.map_feat(feat))
        word_embs = d["lang_feat"]
        state = {"h": hidden}

        def step(prev):
            state["h"] = self.recurrent_cell(prev, state["h"])
            return self.classifier(state["h"]), None

        if not is_eval:
            outs = []
            for t in range(self.max_desc_len + 1):
                logits, _ = step(word_embs[:, t])
                outs.append(logits)
            d["lang_cap"] = torch.stack(outs, dim=1)
        else:
            d["lang_cap"], _ = _greedy(step, word_embs[:, 0],
                                       d["glove_emb_table"],
                                       self.max_desc_len - 1)
        return d


class ShowAttendAndTell2D(nn.Module):
    """Top-down attention over the context boxes (tdbu.py:7-260): the
    tanh-fused input projections feeding two GRUs with additive attention.
    Every projection that feeds a GRU is bias-free and 128 wide
    (tdbu.py:29-48)."""

    def __init__(self, num_vocabs: int, emb_size: int = 300,
                 feat_size: int = 2048 + 2052, context_size: int = 2052,
                 hidden_size: int = 512, max_desc_len: int = 30,
                 add_global: bool = True):
        super().__init__()
        self.hidden_size = hidden_size
        self.max_desc_len = max_desc_len
        self.add_global = add_global
        if add_global:
            self.reduce_dim = nn.Linear(feat_size, context_size)
        self.map_topdown_1 = nn.Linear(hidden_size, 128, bias=False)
        self.map_topdown_2 = nn.Linear(context_size, 128, bias=False)
        self.map_topdown_3 = nn.Linear(emb_size, 128, bias=False)
        self.map_topdown = nn.Linear(128, 128, bias=False)
        self.recurrent_cell_1 = GRUCell(128, hidden_size)
        self.map_feat = nn.Linear(context_size, hidden_size, bias=False)
        self.map_hidd = nn.Linear(hidden_size, hidden_size, bias=False)
        self.attend = nn.Linear(hidden_size, 1, bias=False)
        self.map_lang_1 = nn.Linear(context_size, 128, bias=False)
        self.map_lang_2 = nn.Linear(hidden_size, 128, bias=False)
        self.map_lang = nn.Linear(128, 128, bias=False)
        self.recurrent_cell_2 = GRUCell(128, hidden_size)
        self.classifier = nn.Linear(hidden_size, num_vocabs)

    def _decode(self, t_feat, c_feat, word_embs, emb_table, num_steps,
                teacher_forcing):
        N = t_feat.shape[0]
        state = {"h1": t_feat.new_zeros((N, self.hidden_size)),
                 "h2": t_feat.new_zeros((N, self.hidden_size))}
        mapped_ctx = self.map_feat(c_feat)

        def step(prev):
            x = torch.tanh(self.map_topdown_3(prev)
                           + self.map_topdown_1(state["h2"])
                           + self.map_topdown_2(t_feat))
            x = torch.relu(self.map_topdown(x))
            h1 = self.recurrent_cell_1(x, state["h1"])
            combined = torch.tanh(mapped_ctx + self.map_hidd(h1)[:, None, :])
            attn = torch.softmax(self.attend(combined), dim=1)
            attended = torch.sum(c_feat * attn, dim=1)
            lang = torch.tanh(self.map_lang_1(attended) + self.map_lang_2(h1))
            lang = torch.relu(self.map_lang(lang))
            h2 = self.recurrent_cell_2(lang, state["h2"])
            state["h1"], state["h2"] = h1, h2
            return self.classifier(h2), attn[..., 0]

        if teacher_forcing:
            outs, attns = [], []
            for t in range(num_steps):
                logits, attn = step(word_embs[:, t])
                outs.append(logits)
                attns.append(attn)
            caps = torch.stack(outs, dim=1)
        else:
            caps, attns = _greedy(step, word_embs[:, 0], emb_table,
                                  num_steps)
        # the attention masks on the LAST axis, as the reference cats them
        # (tdbu.py:213-214: (B, num_proposals, steps) "topdown_attn")
        return caps, torch.stack(attns, dim=-1)

    def forward(self, data_dict: Dict, is_eval: bool = False) -> Dict:
        d = dict(data_dict)
        if self.add_global:
            t_feat = torch.cat([d["g_feat"], d["t_feat"]], dim=-1)
            t_feat = torch.relu(self.reduce_dim(t_feat))
        else:
            t_feat = d["t_feat"]
        d["inp_feat"] = t_feat
        c_feat = d["c_feats"]
        if not is_eval:
            d["lang_cap"], d["topdown_attn"] = self._decode(
                t_feat, c_feat, d["lang_feat"], None,
                self.max_desc_len + 1, True)
        else:
            # the reference's inference path feeds the RAW t_feat, not the
            # reduced global concat its train path uses (tdbu.py:227 vs
            # :174; the widths coincide at context_size), kept for the
            # parity of converted checkpoints
            d["lang_cap"], d["topdown_attn"] = self._decode(
                d["t_feat"], c_feat, d["lang_feat"], d["glove_emb_table"],
                self.max_desc_len - 1, False)
        return d


class Retrieval2D:
    """Cosine nearest-neighbour caption transfer (retr.py:6-48), on the
    host with no parameters: rank the train targets' features, return the
    best one's caption."""

    def __init__(self, train_feats: Dict[str, np.ndarray],
                 train_lang_ids: Dict[str, np.ndarray], ignore_last: int = 4):
        self.keys = list(train_feats.keys())
        self.bank = np.stack([np.asarray(train_feats[k]) for k in self.keys])
        if ignore_last:
            self.bank = self.bank[:, :-ignore_last]
        self.bank_norm = self.bank / (
            np.linalg.norm(self.bank, axis=1, keepdims=True) + 1e-12)
        self.train_lang_ids = train_lang_ids
        self.ignore_last = ignore_last

    def __call__(self, data_dict: Dict) -> list:
        feats = np.asarray(data_dict["t_feat"])
        if self.ignore_last:
            feats = feats[:, :-self.ignore_last]
        q = feats / (np.linalg.norm(feats, axis=1, keepdims=True) + 1e-12)
        sims = q @ self.bank_norm.T                     # (B, n_train)
        best = sims.argmax(-1)
        return [self.train_lang_ids[self.keys[i]] for i in best]
