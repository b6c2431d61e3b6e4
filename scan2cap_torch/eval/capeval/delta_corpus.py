"""Synthetic ScanRefer-shaped caption-pair corpus for METEOR backend studies
(copy of ``scan2cap_tpu/eval/capeval/delta_corpus.py``).

A template generator over the indoor-scene vocabulary produces ground-truth
captions; hypotheses are derived with the error modes real captioners
exhibit (synonym substitutions, dropped tokens, local reorderings,
truncation) at controlled rates.  Because the generator KNOWS every
substitution it made, the corpus supports an ORACLE synonym stage — one
that recognizes exactly the substitution pairs used — which upper-bounds
what any synonym/paraphrase matcher (including meteor-1.5's WordNet +
paraphrase-table stages) could recover on this distribution.

Consumer: eval/capeval/calibration.py (the offline densecap threshold
calibration).
"""

from __future__ import annotations

from typing import Dict, FrozenSet, List, Tuple

import numpy as np

from scan2cap_torch.eval.capeval.synonyms import SYNONYM_GROUPS

OBJECTS = ["chair", "table", "couch", "bed", "desk", "cabinet", "shelf",
           "toilet", "sink", "refrigerator", "television", "trashcan",
           "lamp", "door", "window", "pillow", "monitor", "stool",
           "dresser", "bookshelf", "curtain", "mirror", "bench", "box"]
COLORS = ["black", "white", "brown", "gray", "red", "blue", "green", "tan",
          "dark", "light", "beige", "purple"]
SIZES = ["small", "large", "big", "tall", "long", "round", "rectangular",
         "narrow", "wide", "tiny", "square", "flat"]
ANCHORS = ["wall", "door", "window", "corner", "bed", "table", "desk",
           "couch", "shelf", "sink", "doorway", "counter"]
RELATIONS = ["next to", "near", "under", "above", "beside", "behind",
             "in front of", "to the left of", "to the right of",
             "across from", "between", "against"]
VERBS = ["is", "sits", "stands", "is placed", "is located", "rests",
         "is positioned", "hangs"]

TEMPLATES = [
    "sos this is a {size} {color} {obj} . it {verb} {rel} the {anchor} . eos",
    "sos the {color} {obj} {verb} {rel} the {anchor} . it is {size} . eos",
    "sos there is a {size} {obj} {rel} the {anchor} . it is {color} . eos",
    "sos a {color} {size} {obj} . the {obj} {verb} {rel} the {anchor} . eos",
]

# word -> candidate synonym substitutions, derived from the same curated
# groups the domsyn stage uses (so substitutions are realistic paraphrases,
# not random noise) plus common caption near-synonyms the table REJECTS
# (table/desk, cup/mug) to keep the hypothesis distribution honest.
SUBSTITUTIONS: Dict[str, List[str]] = {}
for _group in SYNONYM_GROUPS:
    for _w in _group:
        SUBSTITUTIONS.setdefault(_w, []).extend(
            x for x in _group if x != _w)
for _a, _b in (("table", "desk"), ("desk", "table"), ("trashcan", "bin"),
               ("television", "screen"), ("cabinet", "cupboard")):
    SUBSTITUTIONS.setdefault(_a, []).append(_b)


# --- oracle synonym stage -------------------------------------------------
# Each unordered substitution pair gets one id; a word's id set is the set
# of pairs it participates in.  Two words are oracle-synonyms iff the
# generator could have substituted one for the other — the complete synonym
# knowledge on this corpus, hence an upper bound for wordnet+paraphrase.
_ORACLE_IDS: Dict[str, FrozenSet] = {}


def _build_oracle():
    pair_ids: Dict[Tuple[str, str], int] = {}
    sets: Dict[str, set] = {}
    for a, subs in SUBSTITUTIONS.items():
        for b in subs:
            key = (a, b) if a < b else (b, a)
            pid = pair_ids.setdefault(key, len(pair_ids))
            sets.setdefault(a, set()).add(pid)
            sets.setdefault(b, set()).add(pid)
    for w, s in sets.items():
        _ORACLE_IDS[w] = frozenset(s)


_build_oracle()
_EMPTY: FrozenSet = frozenset()


def oracle_synonym_ids(word: str) -> FrozenSet:
    """Key function for meteor._align's callable syn_stage: two words match
    iff the corpus generator treats them as substitutable."""
    return _ORACLE_IDS.get(word.lower(), _EMPTY)


def make_pair(rs: np.random.RandomState) -> Tuple[str, str]:
    fields = dict(
        size=rs.choice(SIZES), color=rs.choice(COLORS),
        obj=rs.choice(OBJECTS), verb=rs.choice(VERBS),
        rel=rs.choice(RELATIONS), anchor=rs.choice(ANCHORS))
    ref = rs.choice(TEMPLATES).format(**fields)
    toks = ref.split()
    out = []
    for t in toks:
        r = rs.rand()
        if r < 0.18 and t in SUBSTITUTIONS:         # synonym substitution
            subs = SUBSTITUTIONS[t]
            out.append(subs[rs.randint(len(subs))])
        elif r < 0.24 and t not in ("sos", "eos"):  # drop
            continue
        else:
            out.append(t)
    # local swap
    if len(out) > 4 and rs.rand() < 0.3:
        i = rs.randint(1, len(out) - 2)
        out[i], out[i + 1] = out[i + 1], out[i]
    # truncation (decoder ran out of steps)
    if len(out) > 6 and rs.rand() < 0.15:
        out = out[: rs.randint(6, len(out))]
    return ref, " ".join(out)


def make_pairs(n: int, seed: int = 0) -> List[Tuple[str, str]]:
    rs = np.random.RandomState(seed)
    return [make_pair(rs) for _ in range(n)]
