"""CIDEr (Vedantam et al. 2015), coco-caption conventions.

Behavioral parity targets (lib/capeval/cider/cider_scorer.py):
  * n = 1..4, sigma = 6.0;
  * document frequency counted over reference *sets* per image;
  * log reference length = log(number of images);
  * tf-idf weight = count * (log(N_images) - log(max(1, df)));
  * similarity with clipping: sum over hyp ngrams of
    min(hyp_w, ref_w) * ref_w, divided by both norms;
  * gaussian length penalty exp(-(len_h - len_r)^2 / (2 sigma^2)) applied
    per n; mean over n, mean over refs, times 10.
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, List, Tuple

import numpy as np


def _ngrams(tokens: List[str], n: int = 4) -> Counter:
    out = Counter()
    for k in range(1, n + 1):
        for i in range(len(tokens) - k + 1):
            out[tuple(tokens[i:i + k])] += 1
    return out


class Cider:
    def __init__(self, test=None, refs=None, n: int = 4, sigma: float = 6.0):
        self._n = n
        self._sigma = sigma

    def compute_score(self, gts: Dict, res: Dict) -> Tuple[float, np.ndarray]:
        assert set(gts.keys()) == set(res.keys())
        keys = list(gts.keys())

        crefs = [[_ngrams(r.split(), self._n) for r in gts[k]] for k in keys]
        ctest = [_ngrams(res[k][0].split(), self._n) for k in keys]

        # document frequency over reference sets
        df = defaultdict(float)
        for refs in crefs:
            for g in set(g for ref in refs for g in ref):
                df[g] += 1
        log_nimg = math.log(float(len(crefs)))

        def to_vec(cnts: Counter):
            vec = [defaultdict(float) for _ in range(self._n)]
            norm = [0.0] * self._n
            length = 0
            for g, tf in cnts.items():
                idf = log_nimg - math.log(max(1.0, df[g]))
                k = len(g) - 1
                vec[k][g] = float(tf) * idf
                norm[k] += vec[k][g] ** 2
                if k == 1:
                    length += tf
            return vec, [math.sqrt(x) for x in norm], length

        def sim(vh, vr, nh, nr, lh, lr):
            delta = float(lh - lr)
            val = np.zeros(self._n)
            for k in range(self._n):
                for g in vh[k]:
                    val[k] += min(vh[k][g], vr[k][g]) * vr[k][g]
                if nh[k] != 0 and nr[k] != 0:
                    val[k] /= nh[k] * nr[k]
                val[k] *= math.exp(-(delta ** 2) / (2 * self._sigma ** 2))
            return val

        scores = []
        for test, refs in zip(ctest, crefs):
            vec, norm, length = to_vec(test)
            score = np.zeros(self._n)
            for ref in refs:
                vr, nr, lr = to_vec(ref)
                score += sim(vec, vr, norm, nr, length, lr)
            scores.append(float(np.mean(score)) / len(refs) * 10.0)
        scores = np.asarray(scores)
        return float(np.mean(scores)), scores

    def method(self):
        return "CIDEr"
