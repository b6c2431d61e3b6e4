"""The 2D dataset: feature store + captions (counterpart of
``scan2cap_tpu/twod/dataset.py``; reference Scan2Cap-2D/lib/data*.py).

The store (``data/feature_store.py``; one per (viewpoint, box source)):
  <sample_id>/g_feat  (2048,)        global ResNet101 image feature
  <sample_id>/t_feat  (2052,)        target box feature (+4 box coords)
  <sample_id>/c_feats (P, 2052)      context box features (may be absent)
with sample_id = "{scene_id}-{object_id}_{ann_id}" (the 'kkk' key type).
The items are the JAX package's key for key: the same dtypes, the context
boxes zero-padded to ``num_proposals`` with their mask.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Dict, Optional, Sequence

import numpy as np

from scan2cap_torch.data.feature_store import open_feature_store
from scan2cap_torch.data.vocab import (build_embedding_table,
                                       build_vocabulary, encode_caption)
from scan2cap_torch.twod.conf import TwoDConfig


def sample_id_of(entry: dict, key_type: str = "kkk") -> str:
    if key_type == "kkk":
        return "{}-{}_{}".format(entry["scene_id"], entry["object_id"],
                                 entry["ann_id"])
    if key_type == "kk":
        return "{}-{}".format(entry["scene_id"], entry["object_id"])
    return entry["scene_id"]


class TwoDDataset:
    def __init__(self, scanrefer: Sequence[dict], cfg: TwoDConfig,
                 glove: Dict, vocab: Optional[Dict] = None,
                 db_path: Optional[str] = None):
        self.scanrefer = list(scanrefer)
        self.cfg = cfg
        self.glove = glove
        self.vocabulary = vocab if vocab is not None else build_vocabulary(
            self.scanrefer, glove, cfg.max_desc_len)
        self.num_vocabs = len(self.vocabulary["word2idx"])
        self.emb_table = build_embedding_table(self.vocabulary, glove)
        self.db_path = db_path or cfg.db_path
        self._db = None
        self._db_lock = threading.Lock()

    def _store(self):
        if self._db is None:
            # the Loader's worker threads race through here: one handle,
            # opened under the lock, and its backend announced once
            with self._db_lock:
                if self._db is None:
                    db = open_feature_store(self.db_path)
                    backend = db.attrs.get("extractor_backend", "unknown")
                    print(f"[twod] feature db "
                          f"{os.path.basename(self.db_path)}: "
                          f"extractor={backend}")
                    if backend == "random-projection-fallback":
                        print("[twod] WARNING: features are the "
                              "non-semantic random-projection fallback — "
                              "metrics from this db are pipeline smoke "
                              "tests only", file=sys.stderr)
                    self._db = db
        return self._db

    def __len__(self):
        return len(self.scanrefer)

    def __getitem__(self, idx: int,
                    rs: Optional[np.random.RandomState] = None) -> Dict:
        start = time.time()
        entry = self.scanrefer[idx]
        sid = sample_id_of(entry)
        db = self._store()
        g_feat = np.asarray(db[f"{sid}/g_feat"], np.float32)
        t_feat = np.asarray(db[f"{sid}/t_feat"], np.float32)
        c_raw = (np.asarray(db[f"{sid}/c_feats"], np.float32)
                 if f"{sid}/c_feats" in db
                 else np.zeros((0, self.cfg.target_feat_size), np.float32))
        P = self.cfg.num_proposals
        c_feats = np.zeros((P, c_raw.shape[-1] if len(c_raw) else
                            self.cfg.target_feat_size), np.float32)
        n = min(len(c_raw), P)
        c_feats[:n] = c_raw[:n]

        lang_feat, lang_ids, lang_len = encode_caption(
            entry["token"], self.vocabulary, self.glove, self.cfg.max_desc_len)
        return {
            "g_feat": g_feat,
            "t_feat": t_feat,
            "c_feats": c_feats,
            "c_mask": (np.arange(P) < n).astype(np.float32),
            "lang_feat": lang_feat.astype(np.float32),
            "lang_ids": lang_ids.astype(np.int32),
            "lang_len": np.int32(min(lang_len, self.cfg.max_desc_len + 2)),
            "dataset_idx": np.int32(idx),
            "load_time": np.float32(time.time() - start),
        }
