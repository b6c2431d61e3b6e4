"""ROUGE-L (Lin & Hovy 2004), coco-caption conventions
(lib/capeval/rouge/rouge.py): LCS precision/recall per reference, max over
references of each, F-measure with beta = 1.2.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def _lcs_len(a: List[str], b: List[str]) -> int:
    if len(a) < len(b):
        a, b = b, a
    prev = [0] * (len(b) + 1)
    for i in range(1, len(a) + 1):
        cur = [0] * (len(b) + 1)
        ai = a[i - 1]
        for j in range(1, len(b) + 1):
            cur[j] = prev[j - 1] + 1 if ai == b[j - 1] else max(prev[j], cur[j - 1])
        prev = cur
    return prev[len(b)]


class Rouge:
    def __init__(self, beta: float = 1.2):
        self.beta = beta

    def calc_score(self, candidate: List[str], refs: List[str]) -> float:
        tokens_c = candidate[0].split(" ")
        precs, recs = [], []
        for ref in refs:
            tokens_r = ref.split(" ")
            lcs = _lcs_len(tokens_r, tokens_c)
            precs.append(lcs / float(len(tokens_c)))
            recs.append(lcs / float(len(tokens_r)))
        p, r = max(precs), max(recs)
        if p != 0 and r != 0:
            return ((1 + self.beta ** 2) * p * r) / (r + self.beta ** 2 * p)
        return 0.0

    def compute_score(self, gts: Dict, res: Dict) -> Tuple[float, np.ndarray]:
        assert set(gts.keys()) == set(res.keys())
        scores = np.asarray([self.calc_score(res[k], gts[k]) for k in gts])
        return float(np.mean(scores)), scores

    def method(self):
        return "Rouge"
