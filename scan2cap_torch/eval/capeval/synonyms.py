"""Curated synonym table (copy of ``scan2cap_tpu/eval/capeval/synonyms.py``) for the METEOR synonym stage.

The reference scores METEOR with WordNet-backed synonymy (meteor-1.5's
synonym module, lib/capeval/meteor/meteor.py:15-45; the densecap grid uses
nltk's wordnet scorer, benchmark/eval_densecap.py:26).  The WordNet corpus
is not shipped with the repository, and without it the synonym stage would
be silently absent.

This table is the documented fallback: hand-curated synonym groups
mirroring WordNet synsets for the ScanRefer/indoor-scene caption domain
(furniture, appliances, rooms, colors, sizes, spatial relations, common
caption verbs) plus high-frequency general-English synonym groups.  Two
words match when they share a group — the same predicate the WordNet
stage applies to synset sets.  It is intentionally conservative: a pair
is included only when the words genuinely share a WordNet synset (or are
tokenization variants of the same caption term), because false synonym
matches RAISE scores and would bias comparisons against published
numbers.  Deliberately absent: near-synonyms that WordNet keeps separate
(table/desk, cup/mug, ceiling/roof, jacket/coat, navy/blue, ...).

When the real nltk WordNet corpus is installed, meteor.py prefers it and
this table is unused.  The backend tag distinguishes the three cases:
``builtin-exact-stem`` < ``builtin-exact-stem-domsyn`` (this table) <
``builtin-exact-stem-wordnet`` (``-stem`` only where a stemmer is loaded).
"""

from __future__ import annotations

from typing import Dict, FrozenSet, List

# Each tuple is one synonym group (an approximate synset).  A word may
# appear in several groups (polysemy), like WordNet membership in several
# synsets.
SYNONYM_GROUPS: List[tuple] = [
    # --- seating / tables / storage ---
    ("couch", "sofa", "lounge"),
    ("stool", "seat"),
    ("bench", "seat"),
    ("chair", "seat"),
    ("ottoman", "footstool", "footrest", "pouf", "pouffe", "hassock"),
    ("nightstand", "bedstand"),
    ("counter", "countertop", "worktop"),
    ("dresser", "bureau", "chiffonier"),
    ("cupboard", "closet"),
    ("wardrobe", "closet", "armoire"),
    ("bookshelf", "bookcase"),
    ("sofa-bed", "daybed", "divan"),
    # --- soft furnishings ---
    ("pillow", "cushion"),
    ("duvet", "comforter", "quilt", "eiderdown"),
    ("rug", "carpet", "carpeting"),
    ("curtain", "drape", "drapery", "curtains", "drapes"),
    # --- appliances / electronics ---
    ("refrigerator", "fridge", "icebox"),
    ("stove", "range", "cookstove"),
    ("television", "tv", "telly"),
    ("monitor", "display", "screen"),
    ("computer", "pc"),
    ("laptop", "notebook"),
    ("telephone", "phone"),
    ("lamp", "light"),
    # --- bathroom ---
    ("toilet", "commode", "lavatory", "loo", "potty", "stool"),
    ("sink", "basin", "washbasin", "washbowl", "lavatory"),
    ("bathtub", "tub", "bath"),
    ("mirror", "looking-glass"),
    ("restroom", "bathroom", "washroom", "lavatory", "toilet"),
    # --- containers / objects ---
    ("trash", "garbage", "rubbish", "refuse", "waste"),
    ("trashcan", "wastebasket", "wastebin", "dustbin", "ashcan",
     "garbage-can", "trash-can"),
    ("box", "carton"),
    ("bag", "sack"),
    ("handbag", "purse", "pocketbook"),
    ("backpack", "knapsack", "rucksack", "packsack", "bookbag", "haversack"),
    ("suitcase", "bag", "grip"),
    ("luggage", "baggage"),
    ("picture", "photo", "photograph", "image", "pic", "exposure"),
    ("painting", "picture"),
    ("poster", "placard", "notice", "bill", "card"),
    ("plant", "flora"),
    ("flowerpot", "planter"),
    ("book", "volume"),
    ("notebook", "notepad", "jotter"),
    ("whiteboard", "markerboard"),
    ("blackboard", "chalkboard"),
    ("bicycle", "bike", "cycle", "wheel"),
    ("piano", "pianoforte", "forte-piano"),
    ("clock", "timepiece"),
    ("heater", "warmer"),
    ("ladder", "stepladder"),
    ("garment", "clothing", "clothes", "apparel", "attire", "wear",
     "wearable", "vesture"),
    ("shoe", "footwear"),
    # --- rooms / structure ---
    ("room", "chamber"),
    ("kitchen", "kitchenette"),
    ("doorway", "door", "entrance", "entry", "entryway", "threshold",
     "room-access"),
    ("windowsill", "sill"),
    ("floor", "flooring"),
    ("stairs", "staircase", "stairway", "steps"),
    ("column", "pillar"),
    ("railing", "rail", "banister", "handrail", "balustrade", "balusters"),
    ("corner", "nook"),
    ("hallway", "hall", "corridor"),
    ("passage", "passageway"),
    # --- colors ---
    ("gray", "grey", "greyish", "grayish"),
    ("crimson", "ruby", "deep-red"),
    ("red", "reddish", "ruddy"),
    ("tan", "topaz"),
    ("beige", "ecru"),
    ("violet", "purple", "purplish", "violaceous"),
    ("turquoise", "greenish-blue", "aqua", "aquamarine", "cobalt-blue"),
    ("teal", "teal-blue"),
    ("golden", "gold", "aureate", "gilded", "gilt"),
    ("silver", "silvery", "argent", "silverish"),
    ("dark", "darkened"),
    ("pale", "light-colored"),
    # --- sizes / shapes ---
    ("big", "large", "sizable", "sizeable"),
    ("small", "little", "diminutive", "petite"),
    ("tiny", "minuscule", "wee", "midget"),
    ("huge", "enormous", "immense", "vast"),
    ("gigantic", "giant", "colossal", "mammoth"),
    ("tall", "high"),
    ("long", "lengthy", "elongated", "elongate"),
    ("wide", "broad"),
    ("narrow", "slim", "thin", "slender"),
    ("round", "circular"),
    ("rectangular", "oblong"),
    ("flat", "level", "even", "plane"),
    ("curved", "curving", "arced", "arched"),
    # --- positions / relations ---
    ("near", "close", "nearby"),
    ("adjacent", "next", "side-by-side", "adjoining", "neighboring"),
    ("under", "underneath", "beneath", "below"),
    ("above", "over", "atop"),
    ("middle", "center", "centre", "midst", "midpoint"),
    ("between", "betwixt"),
    ("opposite", "facing"),
    ("far", "distant", "faraway", "remote"),
    ("end", "terminus"),
    ("edge", "border", "rim", "brink", "margin"),
    ("side", "flank"),
    ("top", "summit", "peak", "crest", "crown"),
    ("bottom", "underside", "undersurface"),
    # --- verbs common in captions (incl. irregular forms the Porter
    #     stemmer cannot relate) ---
    ("sitting", "seated"),
    ("standing", "upright", "erect"),
    ("lying", "reclining", "recumbent"),
    ("hold", "contain", "bear", "carry"),
    ("hanging", "suspended", "dangling"),
    ("placed", "positioned", "situated", "located", "set"),
    ("leaning", "tilted", "inclined"),
    ("attached", "affixed", "fastened", "mounted"),
    # --- general English ---
    ("begin", "start", "commence"),
    ("purchase", "buy"),
    ("couple", "pair", "duo", "twosome"),
    ("several", "various"),
    ("numerous", "many"),
    ("whole", "entire", "complete", "full"),
    ("empty", "vacant", "bare"),
    ("dirty", "soiled", "filthy", "grimy", "grubby", "grungy"),
    ("clean", "spotless", "pristine"),
    ("old", "aged"),
    ("new", "fresh", "brand-new"),
    ("broken", "damaged", "busted"),
    ("open", "opened", "ajar"),
    ("closed", "shut"),
    ("similar", "alike", "comparable"),
    ("different", "distinct", "dissimilar"),
    ("usual", "normal", "typical", "ordinary", "regular"),
    ("strange", "odd", "unusual", "weird", "peculiar"),
    ("quick", "fast", "rapid", "speedy", "swift"),
    ("slow", "sluggish", "unhurried"),
    ("right", "correct", "proper"),
    ("wrong", "incorrect", "improper"),
    ("maybe", "perhaps", "possibly"),
    ("also", "additionally", "furthermore", "likewise", "too"),
]


def _build() -> Dict[str, FrozenSet[int]]:
    table: Dict[str, set] = {}
    for gid, group in enumerate(SYNONYM_GROUPS):
        for w in group:
            table.setdefault(w.lower(), set()).add(gid)
    return {w: frozenset(ids) for w, ids in table.items()}


WORD_TO_GROUPS: Dict[str, FrozenSet[int]] = _build()
_EMPTY: FrozenSet[int] = frozenset()


def synonym_ids(word: str) -> FrozenSet[int]:
    """Group-id set for ``word`` (empty when the word is not in the table);
    two words are domain-synonyms iff their id sets intersect."""
    return WORD_TO_GROUPS.get(word.lower(), _EMPTY)
