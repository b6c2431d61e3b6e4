"""Vocabulary + GloVe embedding table (copy of ``scan2cap_tpu/data/vocab.py``).

Port of the vocabulary machinery inside lib/dataset.py:
  * special tokens ["pad_", "unk", "sos", "eos"] at ids 0-3 — "pad_" is
    distinct from the real word "pad" (lib/dataset.py:182);
  * remaining words sorted by descending train-split frequency, restricted
    to words with a GloVe vector (lib/dataset.py:175-199);
  * caption encoding: tokens truncated to MAX_DES_LEN, wrapped in sos/eos,
    unknown words -> "unk" (lib/dataset.py:144-166);
  * a dense (num_vocabs, 300) embedding table for device-side eval feedback
    (replaces the per-step glove dict lookups, caption_module.py:559-566).
"""

from __future__ import annotations

import json
import os
import pickle
from collections import Counter
from itertools import chain
from typing import Dict, List, Optional, Sequence

import numpy as np


def load_glove(path: str) -> Dict[str, np.ndarray]:
    with open(path, "rb") as f:
        return pickle.load(f)


def build_vocabulary(scanrefer_train: Sequence[dict], glove: Dict,
                     max_des_len: int = 30,
                     save_path: Optional[str] = None) -> Dict:
    """Frequency-sorted vocabulary with ids 0-3 reserved."""
    if save_path and os.path.exists(save_path):
        with open(save_path) as f:
            return json.load(f)
    all_words = chain(*[d["token"][:max_des_len] for d in scanrefer_train])
    counts = Counter(all_words)
    ordered = sorted(((k, v) for k, v in counts.items() if k in glove),
                     key=lambda x: x[1], reverse=True)
    spw = ["pad_", "unk", "sos", "eos"]
    word2idx, idx2word = {}, {}
    for i, (w, _) in enumerate(ordered):
        word2idx[w] = i + len(spw)
        idx2word[str(i + len(spw))] = w
    for i, w in enumerate(spw):
        word2idx[w] = i
        idx2word[str(i)] = w
    vocab = {"word2idx": word2idx, "idx2word": idx2word}
    if save_path:
        with open(save_path, "w") as f:
            json.dump(vocab, f, indent=4)
    return vocab


def build_embedding_table(vocab: Dict, glove: Dict,
                          emb_size: int = 300) -> np.ndarray:
    """(num_vocabs, emb_size) float32 — glove vector per vocab word, unk for
    missing, zeros for pad_."""
    n = len(vocab["word2idx"])
    table = np.zeros((n, emb_size), np.float32)
    unk = np.asarray(glove.get("unk", np.zeros(emb_size)), np.float32)
    for idx_str, word in vocab["idx2word"].items():
        i = int(idx_str)
        if word == "pad_":
            table[i] = glove.get("pad_", np.zeros(emb_size))
        else:
            table[i] = np.asarray(glove.get(word, unk), np.float32)
    return table


def encode_caption(tokens: List[str], vocab: Dict, glove: Dict,
                   max_des_len: int = 30):
    """tokens -> (embeddings (T, 300), ids (T,), length) with T = max+2."""
    tokens = ["sos"] + list(tokens[:max_des_len]) + ["eos"]
    T = max_des_len + 2
    emb = np.zeros((T, 300), np.float32)
    ids = np.zeros((T,), np.int64)
    unk_vec = glove["unk"]
    unk_id = vocab["word2idx"]["unk"]
    for t, tok in enumerate(tokens):
        if tok in glove and tok in vocab["word2idx"]:
            emb[t] = glove[tok]
            ids[t] = vocab["word2idx"][tok]
        else:
            emb[t] = unk_vec
            ids[t] = unk_id
    return emb, ids, len(tokens)


def build_frequency_weights(lang_ids_all: Sequence[np.ndarray],
                            num_vocabs: int) -> np.ndarray:
    """The reference ends up with uniform weights (lib/dataset.py:225);
    kept for API parity."""
    return np.ones((num_vocabs,), np.float64)
