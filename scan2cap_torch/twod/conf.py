"""The 2D baselines' experiment configuration (a copy of
``scan2cap_tpu/twod/conf.py``; reference Scan2Cap-2D/lib/conf.py).

320 x 240 renders, captions of 30 tokens, 300-d GloVe, hidden 512, 2048-d
ResNet101 global features and 2052-d box features (2048 + 4 box
coordinates).  ``get_config`` resolves (exp_type, viewpoint, box, model).
The one change: ``db_path`` names the port's feature store,
``{viewpoint}_{box}_features.npz`` (``data/feature_store.py``), not an
HDF5 file; ``scripts/convert_feature_db.py`` converts the JAX package's.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict

SCAN_WIDTH = 320
SCAN_HEIGHT = 240
MAX_DESC_LEN = 30
EMBEDDING_SIZE = 300
DECODER_HIDDEN_SIZE = 512
GLOBAL_FEATURE_SIZE = 2048
TARGET_FEATURE_SIZE = 2052     # 2048 + 4 normalized box coords
PROPOSAL_FEATURE_SIZE = 2052

VIEWPOINTS = ("annotated", "estimated", "bev")
BOX_SOURCES = ("oracle", "mrcnn", "votenet")
MODELS = ("snt", "tdbu", "retr")


@dataclasses.dataclass(frozen=True)
class TwoDConfig:
    exp_type: str = "nonretrieval"
    viewpoint: str = "annotated"
    box: str = "oracle"
    model: str = "snt"
    add_global: bool = True
    add_target: bool = True
    add_context: bool = False
    max_desc_len: int = MAX_DESC_LEN
    emb_size: int = EMBEDDING_SIZE
    hidden_size: int = DECODER_HIDDEN_SIZE
    global_feat_size: int = GLOBAL_FEATURE_SIZE
    target_feat_size: int = TARGET_FEATURE_SIZE
    num_proposals: int = 10    # context boxes per image (padded)
    data_root: str = dataclasses.field(
        default_factory=lambda: os.environ.get("SCAN2CAP_2D_DATA", "data/2d"))

    @property
    def db_path(self) -> str:
        return os.path.join(
            self.data_root, f"{self.viewpoint}_{self.box}_features.npz")

    @property
    def feat_input(self) -> Dict[str, bool]:
        return {"add_global": self.add_global, "add_target": self.add_target,
                "add_context": self.add_context}


def get_config(exp_type: str, viewpoint: str, box: str,
               model: str = "snt", **kw) -> TwoDConfig:
    assert viewpoint in VIEWPOINTS, viewpoint
    assert box in BOX_SOURCES, box
    assert model in MODELS, model
    if model == "tdbu":
        kw.setdefault("add_context", True)
    return TwoDConfig(exp_type=exp_type, viewpoint=viewpoint, box=box,
                      model=model, **kw)
