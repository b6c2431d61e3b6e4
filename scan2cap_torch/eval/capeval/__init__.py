"""Caption metrics (copy of ``scan2cap_tpu/eval/capeval``) — independent
implementations of the coco-caption algorithms used by the reference
(lib/capeval/): corpus BLEU 1-4 with
closest-reference brevity penalty, CIDEr (n=4, sigma=6), ROUGE-L (beta=1.2),
and METEOR (exact+stem matcher; the reference shells out to meteor-1.5.jar —
lib/capeval/meteor/meteor.py:15-45 — which is supported when the jar exists).

All scorers share the coco API: ``compute_score(gts, res) -> (score, scores)``
with gts/res dicts of key -> list-of-sentence-strings.
"""

from scan2cap_torch.eval.capeval.bleu import Bleu
from scan2cap_torch.eval.capeval.cider import Cider
from scan2cap_torch.eval.capeval.rouge import Rouge
from scan2cap_torch.eval.capeval.meteor import Meteor

__all__ = ["Bleu", "Cider", "Rouge", "Meteor"]
