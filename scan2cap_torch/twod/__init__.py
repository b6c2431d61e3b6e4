"""The 2D captioning baselines (counterpart of ``scan2cap_tpu/twod``;
reference Scan2Cap-2D) over features of rendered viewpoints:

  * ``ShowAndTell2D``: a GRU decoder seeded by the global (+ target)
    image feature;
  * ``ShowAttendAndTell2D``: top-down attention over the image's context
    boxes;
  * ``Retrieval2D``: the caption of the nearest train target by cosine.

The features come from a ResNet (``twod/resnet.py``) over each render and
each box's crop, stored in the port's feature store
(``twod/preprocessing.py``); ``python -m scan2cap_torch.twod.main`` builds
the store, trains, evaluates and builds the retrieval bank.
"""

from scan2cap_torch.twod.conf import TwoDConfig, get_config
from scan2cap_torch.twod.models import (Retrieval2D, ShowAndTell2D,
                                        ShowAttendAndTell2D)

__all__ = ["ShowAndTell2D", "ShowAttendAndTell2D", "Retrieval2D",
           "TwoDConfig", "get_config"]
