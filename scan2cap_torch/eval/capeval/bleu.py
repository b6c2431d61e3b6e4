"""Corpus BLEU (Papineni et al. 2002), coco-caption conventions.

Behavioral parity targets (lib/capeval/bleu/bleu_scorer.py):
  * reference length option "closest" (ties broken toward the shorter ref);
  * corpus score: ratio of summed clipped matches over summed guesses,
    cumulative product over n, n-th root, brevity penalty exp(1-1/ratio)
    applied only when ratio < 1;
  * per-sentence scores use the same formula per sentence (with the
    sentence-level brevity penalty);
  * smoothing constants: correct + 1e-15 over guess + 1e-9.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Dict, List, Sequence, Tuple

_TINY = 1e-15
_SMALL = 1e-9


def _ngram_counts(tokens: Sequence[str], n: int) -> List[Counter]:
    return [Counter(tuple(tokens[i:i + k]) for i in range(len(tokens) - k + 1))
            for k in range(1, n + 1)]


def _closest_ref_len(ref_lens: List[int], test_len: int) -> int:
    # min over (abs distance, length): shorter wins ties
    return min(ref_lens, key=lambda rl: (abs(rl - test_len), rl))


class Bleu:
    def __init__(self, n: int = 4):
        self._n = n

    def compute_score(self, gts: Dict, res: Dict) -> Tuple[List[float], List[List[float]]]:
        assert set(gts.keys()) == set(res.keys())
        n = self._n
        total_guess = [0] * n
        total_correct = [0] * n
        total_testlen = 0
        total_reflen = 0.0
        per_sentence: List[List[float]] = [[] for _ in range(n)]

        for key in gts:
            hypo = res[key]
            assert isinstance(hypo, list) and len(hypo) == 1
            test_tokens = hypo[0].split()
            ref_token_lists = [r.split() for r in gts[key]]
            assert len(ref_token_lists) >= 1

            test_len = len(test_tokens)
            ref_len = _closest_ref_len([len(r) for r in ref_token_lists], test_len)
            total_testlen += test_len
            total_reflen += ref_len

            test_counts = _ngram_counts(test_tokens, n)
            # clip against the max count over references
            max_ref: List[Counter] = [Counter() for _ in range(n)]
            for ref in ref_token_lists:
                for k, cnt in enumerate(_ngram_counts(ref, n)):
                    for g, c in cnt.items():
                        if c > max_ref[k][g]:
                            max_ref[k][g] = c

            guess = [max(0, test_len - k) for k in range(n)]
            correct = [sum(min(c, max_ref[k][g]) for g, c in test_counts[k].items())
                       for k in range(n)]
            for k in range(n):
                total_guess[k] += guess[k]
                total_correct[k] += correct[k]

            # per-sentence score
            bleu = 1.0
            ratio = (test_len + _TINY) / (ref_len + _SMALL)
            for k in range(n):
                bleu *= (correct[k] + _TINY) / (guess[k] + _SMALL)
                s = bleu ** (1.0 / (k + 1))
                if ratio < 1:
                    s *= math.exp(1 - 1 / ratio)
                per_sentence[k].append(s)

        scores = []
        bleu = 1.0
        ratio = (total_testlen + _TINY) / (total_reflen + _SMALL)
        for k in range(n):
            bleu *= (total_correct[k] + _TINY) / (total_guess[k] + _SMALL)
            s = bleu ** (1.0 / (k + 1))
            if ratio < 1:
                s *= math.exp(1 - 1 / ratio)
            scores.append(s)
        return scores, per_sentence

    def method(self):
        return "Bleu"
