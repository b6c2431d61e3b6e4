"""Paraphrase-table matching stage for the builtin METEOR backend (copy of
``scan2cap_tpu/eval/capeval/paraphrase.py``).

meteor-1.5's fourth matcher module matches multi-word PHRASES against a
paraphrase table (the jar ships data/paraphrase-en.gz; reference wrapper
lib/capeval/meteor/meteor.py:15-45).  The table is not shipped with the
repository, so the stage is FILE-GATED: point
``$SCAN2CAP_METEOR_PARAPHRASE`` at a table (or drop ``paraphrase-en.gz``
next to this module) and the stage activates — the backend tag grows a
``-paraphrase`` suffix so scores are never silently mixed across stage
sets.  Without a table, scoring is byte-identical to before.

Accepted line formats (sniffed per line; ``.gz`` or plain text, UTF-8):

    <phrase1> ||| <phrase2>
    <prob> ||| <phrase1> ||| <phrase2>        (meteor-1.5 paraphrase rows)
    <phrase1><TAB><phrase2>[<TAB><prob>]

Probabilities are ignored (the builtin scorer is unweighted — see
meteor.py's simplification note); pairs are treated as symmetric.
"""

from __future__ import annotations

import gzip
import os
from typing import Dict, FrozenSet, List, Optional, Tuple


class ParaphraseTable:
    """Symmetric phrase-pair lookup: ``other(phrase) -> frozenset(str)``."""

    def __init__(self, pairs: Dict[str, FrozenSet[str]], max_len: int):
        self._pairs = pairs
        self.max_len = max_len          # longest phrase, in words

    def __len__(self) -> int:
        return sum(len(v) for v in self._pairs.values()) // 2

    def others(self, phrase: str) -> FrozenSet[str]:
        return self._pairs.get(phrase, frozenset())

    @classmethod
    def load(cls, path: str) -> "ParaphraseTable":
        opener = gzip.open if path.endswith(".gz") else open
        raw: Dict[str, set] = {}
        max_len = 1
        with opener(path, "rt", encoding="utf-8", errors="replace") as f:
            for line in f:
                pair = _parse_line(line)
                if pair is None:
                    continue
                a, b = pair
                if a == b:
                    continue
                raw.setdefault(a, set()).add(b)
                raw.setdefault(b, set()).add(a)
                max_len = max(max_len, a.count(" ") + 1, b.count(" ") + 1)
        return cls({k: frozenset(v) for k, v in raw.items()}, max_len)


def _parse_line(line: str) -> Optional[Tuple[str, str]]:
    line = line.strip()
    if not line or line.startswith("#"):
        return None
    if "|||" in line:
        parts = [p.strip() for p in line.split("|||")]
        if len(parts) == 3 and _is_number(parts[0]):
            parts = parts[1:]                   # <prob> ||| <p1> ||| <p2>
        if len(parts) != 2 or not parts[0] or not parts[1]:
            return None
        return parts[0].lower(), parts[1].lower()
    if "\t" in line:
        parts = [p.strip() for p in line.split("\t")]
        if len(parts) >= 3 and _is_number(parts[2]):
            parts = parts[:2]
        if len(parts) != 2 or not parts[0] or not parts[1]:
            return None
        return parts[0].lower(), parts[1].lower()
    return None


def _is_number(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False


def default_table_path() -> Optional[str]:
    """The gate: env override first, then a file dropped next to capeval."""
    for p in (
        os.environ.get("SCAN2CAP_METEOR_PARAPHRASE", ""),
        os.path.join(os.path.dirname(__file__), "paraphrase-en.gz"),
    ):
        if p and os.path.exists(p):
            return p
    return None


def phrase_stage(hyp: List[str], ref: List[str],
                 used_h: List[bool], used_r: List[bool],
                 table: ParaphraseTable) -> Tuple[List[Tuple[int, int]],
                                                  int, int]:
    """Greedy paraphrase matching over spans of still-unmatched tokens.

    Longest hyp span first (meteor's aligner also prefers covering more
    words), earliest ref span wins; a matched pair may cover differing
    span lengths, so the hyp-side and ref-side covered-word counts are
    returned separately (the scorer uses them for precision vs recall).
    Word-level pairs (for the fragmentation/chunk count) pair up the
    first ``min(lh, lr)`` positions of the two spans.
    """
    matches: List[Tuple[int, int]] = []
    m_h = m_r = 0
    L = table.max_len
    for lh in range(min(L, len(hyp)), 0, -1):
        for i in range(0, len(hyp) - lh + 1):
            if any(used_h[i:i + lh]):
                continue
            others = table.others(" ".join(hyp[i:i + lh]))
            if not others:
                continue
            hit = None
            for j in range(0, len(ref)):
                for lr in range(1, min(L, len(ref) - j) + 1):
                    if used_r[j + lr - 1]:
                        break               # span would cover a used token
                    if " ".join(ref[j:j + lr]) in others:
                        hit = (j, lr)
                        break
                if hit:
                    break
            if not hit:
                continue
            j, lr = hit
            for k in range(lh):
                used_h[i + k] = True
            for k in range(lr):
                used_r[j + k] = True
            matches.extend((i + k, j + k) for k in range(min(lh, lr)))
            m_h += lh
            m_r += lr
    return matches, m_h, m_r
