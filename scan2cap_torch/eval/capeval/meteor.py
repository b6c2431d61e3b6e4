"""METEOR scorer (copy of ``scan2cap_tpu/eval/capeval/meteor.py``; the
backend tag says ``-stem`` only where a stemmer is loaded).

Two backends:
  * ``MeteorJava`` — drives a meteor-1.5.jar over the same stdin/stdout
    protocol the reference uses (lib/capeval/meteor/meteor.py:15-45);
    used automatically when a jar path is supplied/found.
  * ``Meteor`` (default) — pure-Python METEOR with exact + Porter-stem
    (+ WordNet-synonym, when the nltk wordnet corpus is installed;
    + paraphrase, when a table is supplied — see paraphrase.py) matching
    stages and the standard parameters (alpha=0.9, beta=3, gamma=0.5;
    Banerjee & Lavie / Denkowski & Lavie).  Without WordNet data the
    synonym stage falls back to the curated domain table, and without a
    paraphrase file that stage is absent, so absolute values run slightly
    lower than meteor-1.5 (fewer matches can only lower the F-mean) — the
    relative ordering is preserved.  Multiple references: max over
    references.

Which stages scored a run is exposed as ``METEOR_BACKEND`` / the scorer's
``.backend`` attribute and recorded by every metrics consumer — scores
from different backends are not comparable against the absolute
meteor-calibrated thresholds (benchmark densecap grid .15-.75).
"""

from __future__ import annotations

import os
import subprocess
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

# The stem stage needs nltk's Porter stemmer.  Without nltk it matches
# exact forms again (an identity stem), and the backend tag leaves out
# "-stem", so that a run says which stages scored it.
try:
    from nltk.stem.porter import PorterStemmer
    _STEMMER = PorterStemmer()
    _HAS_STEMMER = True

    def _stem(w: str) -> str:
        return _STEMMER.stem(w)
except ImportError:
    _HAS_STEMMER = False

    def _stem(w: str) -> str:
        return w

# WordNet-synonym matching stage (meteor-1.5's third module): active when
# the nltk wordnet corpus is installed.  Which stages scored a
# run is part of the result — see METEOR_BACKEND.
try:
    from nltk.corpus import wordnet as _wn
    _wn.synsets("dog")                      # probes the corpus data
    _HAS_WORDNET = True
except Exception:
    _wn = None
    _HAS_WORDNET = False

# Without the WordNet corpus (not shipped with the repository) the synonym
# stage falls back to the curated domain synset table (synonyms.py) instead
# of silently disappearing.  Disable via
# SCAN2CAP_METEOR_NO_DOMSYN=1 for a pure exact+stem A/B.
_USE_DOMSYN = (not _HAS_WORDNET
               and not os.environ.get("SCAN2CAP_METEOR_NO_DOMSYN"))

# meteor-1.5's fourth matcher (phrase paraphrases) is FILE-GATED: the table
# ships inside the jar and can't be vendored offline, but supplying one via
# $SCAN2CAP_METEOR_PARAPHRASE (or paraphrase-en.gz next to this package)
# activates the stage — see paraphrase.py for formats and semantics.
from scan2cap_torch.eval.capeval import paraphrase as _paraphrase

_PARA_PATH = _paraphrase.default_table_path()
_PARA_TABLE: Optional["_paraphrase.ParaphraseTable"] = None
_PARA_LOCK = threading.Lock()


def _para_table() -> Optional["_paraphrase.ParaphraseTable"]:
    global _PARA_TABLE
    if _PARA_PATH is None:
        return None
    if _PARA_TABLE is None:
        with _PARA_LOCK:
            if _PARA_TABLE is None:
                _PARA_TABLE = _paraphrase.ParaphraseTable.load(_PARA_PATH)
    return _PARA_TABLE


METEOR_BACKEND = ("builtin-exact" + ("-stem" if _HAS_STEMMER else "")
                  + ("-wordnet" if _HAS_WORDNET
                     else "-domsyn" if _USE_DOMSYN else ""))
if _PARA_PATH is not None:
    METEOR_BACKEND += "-paraphrase"

# default synonym stage for this process; single_meteor_score accepts an
# explicit override so A/B studies (scripts/micro_meteor_delta.py) can
# compare stages without re-importing under different env vars
_DEFAULT_SYN_STAGE = ("wordnet" if _HAS_WORDNET
                      else "domsyn" if _USE_DOMSYN else None)

ALPHA = 0.9
BETA = 3.0
GAMMA = 0.5


if _HAS_WORDNET:
    import functools

    @functools.lru_cache(maxsize=65536)
    def _synset_ids(w: str) -> frozenset:
        """Cached WordNet synset-name set (corpus lookups are ~0.1 ms each —
        uncached, an O(H·R) alignment pays thousands per sentence pair)."""
        return frozenset(s.name() for s in _wn.synsets(w))


def _align(hyp: List[str], ref: List[str], syn_stage="auto",
           para="auto") -> Tuple[List[Tuple[int, int]], int, int]:
    """Greedy staged (exact, stem[, synonym][, paraphrase]) alignment:
    each hyp token matches the earliest unmatched ref token.  Per-token
    keys (stems, synset sets) are computed ONCE per sentence, not per pair.
    ``syn_stage``: "auto" (process default), "wordnet", "domsyn", None, or
    a callable ``word -> frozenset`` key function (custom synonym table —
    used by the calibration oracle, capeval/delta_corpus.py).
    ``para``: "auto" (the file-gated process default), None, or an explicit
    ``paraphrase.ParaphraseTable``.

    Returns ``(matches, m_h, m_r)`` — word-level match pairs (for the
    fragmentation count) plus the matched-word totals on each side, which
    differ only when a paraphrase pairs spans of different lengths."""
    if syn_stage == "auto":
        syn_stage = _DEFAULT_SYN_STAGE
    matches: List[Tuple[int, int]] = []
    used_h = [False] * len(hyp)
    used_r = [False] * len(ref)

    def stage(hkeys, rkeys, match_fn):
        for i, hk in enumerate(hkeys):
            if used_h[i]:
                continue
            for j, rk in enumerate(rkeys):
                if not used_r[j] and match_fn(hk, rk):
                    used_h[i] = used_r[j] = True
                    matches.append((i, j))
                    break

    eq = lambda a, b: a == b
    stage(hyp, ref, eq)
    stage([_stem(w) for w in hyp], [_stem(w) for w in ref], eq)
    overlap = lambda a, b: bool(a) and not a.isdisjoint(b)
    if callable(syn_stage):
        stage([syn_stage(w) for w in hyp], [syn_stage(w) for w in ref],
              overlap)
    elif syn_stage == "wordnet":
        if not _HAS_WORDNET:
            raise RuntimeError("wordnet synonym stage requested but the "
                               "nltk wordnet corpus is not installed")
        # meteor-1.5 synonymy: the words share a synset
        stage([_synset_ids(w) for w in hyp], [_synset_ids(w) for w in ref],
              overlap)
    elif syn_stage == "domsyn":
        # same predicate over the curated domain synset table
        from scan2cap_torch.eval.capeval.synonyms import synonym_ids
        stage([synonym_ids(w) for w in hyp], [synonym_ids(w) for w in ref],
              overlap)
    m_h = m_r = len(matches)
    if para == "auto":
        para = _para_table()
    if para is not None:
        pm, ph, pr = _paraphrase.phrase_stage(hyp, ref, used_h, used_r, para)
        matches.extend(pm)
        m_h += ph
        m_r += pr
    matches.sort()
    return matches, m_h, m_r


def _count_chunks(matches: List[Tuple[int, int]]) -> int:
    if not matches:
        return 0
    chunks = 1
    for (h0, r0), (h1, r1) in zip(matches, matches[1:]):
        if h1 != h0 + 1 or r1 != r0 + 1:
            chunks += 1
    return chunks


def single_meteor_score(ref: str, hyp: str, syn_stage="auto",
                        para="auto") -> float:
    hyp_t = hyp.split()
    ref_t = ref.split()
    if not hyp_t or not ref_t:
        return 0.0
    matches, m_h, m_r = _align(hyp_t, ref_t, syn_stage, para)
    if m_h == 0:
        return 0.0
    precision = m_h / len(hyp_t)
    recall = m_r / len(ref_t)
    fmean = (precision * recall) / (ALPHA * precision + (1 - ALPHA) * recall)
    chunks = _count_chunks(matches)
    # fragmentation over the mean matched-word count; m_h == m_r (== the
    # word-level match count) except when a paraphrase pairs spans of
    # different lengths, so the word-stage-only score is unchanged
    frag = chunks / ((m_h + m_r) / 2)
    penalty = GAMMA * frag ** BETA
    return (1 - penalty) * fmean


class Meteor:
    """Pure-Python backend with the coco compute_score API."""

    backend = METEOR_BACKEND

    def compute_score(self, gts: Dict, res: Dict) -> Tuple[float, np.ndarray]:
        assert set(gts.keys()) == set(res.keys())
        scores = np.asarray([
            max(single_meteor_score(ref, res[k][0]) for ref in gts[k])
            for k in gts
        ])
        return float(np.mean(scores)), scores

    def method(self):
        return "METEOR"


def find_meteor_jar() -> Optional[str]:
    for p in (
        os.environ.get("METEOR_JAR", ""),
        os.path.join(os.path.dirname(__file__), "meteor-1.5.jar"),
    ):
        if p and os.path.exists(p):
            return p
    return None


class MeteorJava:
    """meteor-1.5.jar over stdio (protocol of the original coco wrapper)."""

    backend = "java-meteor-1.5"

    def __init__(self, jar: Optional[str] = None):
        self.jar = jar or find_meteor_jar()
        if self.jar is None:
            raise FileNotFoundError("meteor-1.5.jar not found")
        self.lock = threading.Lock()
        self.proc = subprocess.Popen(
            ["java", "-jar", "-Xmx2G", self.jar, "-", "-", "-stdio",
             "-l", "en", "-norm"],
            cwd=os.path.dirname(os.path.abspath(self.jar)),
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            universal_newlines=True, bufsize=1)

    def compute_score(self, gts: Dict, res: Dict) -> Tuple[float, np.ndarray]:
        assert set(gts.keys()) == set(res.keys())
        keys = list(gts.keys())
        scores = []
        with self.lock:
            eval_line = "EVAL"
            for k in keys:
                stat_line = "SCORE ||| {} ||| {}".format(
                    " ||| ".join(s.replace("|||", "").replace("  ", " ")
                                 for s in gts[k]),
                    res[k][0].replace("|||", "").replace("  ", " "))
                self.proc.stdin.write(stat_line + "\n")
                eval_line += " ||| " + self.proc.stdout.readline().strip()
            self.proc.stdin.write(eval_line + "\n")
            for _ in keys:
                scores.append(float(self.proc.stdout.readline().strip()))
            final = float(self.proc.stdout.readline().strip())
        return final, np.asarray(scores)

    def close(self):
        if self.proc:
            self.proc.kill()

    def method(self):
        return "METEOR"
