"""Static model configuration (copy of ``scan2cap_tpu/config.py:45-163``).

Only what the ported paths read: ``ModelConfig``, the ScanNet
mean-size table and the class names.  Field names and defaults are the JAX package's, so a
config written for one package reads the same in the other.  The
TPU-only knobs (``compute_dtype``, ``storage_dtype``, ``bf16_components``,
``spatial_axis``) are not carried: the port computes in float32 and runs
on one card.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

SCANNET_TYPE2CLASS = {
    "cabinet": 0, "bed": 1, "chair": 2, "sofa": 3, "table": 4, "door": 5,
    "window": 6, "bookshelf": 7, "picture": 8, "counter": 9, "desk": 10,
    "curtain": 11, "refrigerator": 12, "shower curtain": 13, "toilet": 14,
    "sink": 15, "bathtub": 16, "others": 17,
}
SCANNET_CLASS2TYPE = {v: k for k, v in SCANNET_TYPE2CLASS.items()}

# Per-class mean box sizes (meters), from the reference's
# meta_data/scannet_reference_means.npz (18 x 3).
SCANNET_MEAN_SIZE_ARR = np.array([
    [0.77504910, 0.94897728, 0.96542059],   # cabinet
    [1.86903267, 1.83214712, 1.19222992],   # bed
    [0.61214778, 0.61928731, 0.70480848],   # chair
    [1.44113898, 1.60452036, 0.83652295],   # sofa
    [1.04780726, 1.20164188, 0.63457007],   # table
    [0.56101232, 0.60847217, 1.71950401],   # door
    [1.07894895, 0.82033996, 1.16921199],   # window
    [0.84171092, 1.35047945, 1.68989250],   # bookshelf
    [0.23051737, 0.47640499, 0.56569256],   # picture
    [1.45484899, 1.97119895, 0.28643280],   # counter
    [1.07858031, 1.53705113, 0.86501906],   # desk
    [1.43119644, 0.76923111, 1.64982673],   # curtain
    [0.62969194, 0.70871287, 1.31433587],   # refrigerator
    [0.43925034, 0.41569594, 1.70002748],   # shower curtain
    [0.58504462, 0.57878438, 0.72029611],   # toilet
    [0.51158693, 0.50960673, 0.31287360],   # sink
    [1.17320759, 1.05987140, 0.51812528],   # bathtub
    [0.43294385, 0.51933507, 0.48437456],   # others
], dtype=np.float32)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static shape + architecture constants of the CapNet pipeline."""

    num_points: int = 40000          # scripts/train.py:320
    num_proposals: int = 256         # scripts/train.py:321
    # SA-layer point counts (backbone_module.py:28-62); shrink for tests
    sa_npoints: Tuple[int, int, int, int] = (2048, 1024, 512, 256)
    max_num_obj: int = 128           # lib/dataset.py:28
    max_des_len: int = 30            # lib/config.py:63 (tokens excl. sos/eos)
    num_bins: int = 6                # lib/config.py:67 (edge orientation bins)
    vote_factor: int = 1
    num_class: int = 18
    num_heading_bin: int = 1
    num_size_cluster: int = 18
    emb_size: int = 300              # GloVe dim
    feat_size: int = 128             # proposal feature dim
    hidden_size: int = 512           # caption decoder hidden
    num_locals: int = 10             # README.md:145 canonical config
    num_graph_steps: int = 0
    query_mode: str = "center"       # scripts/train.py:329 default
    graph_mode: str = "edge_conv"    # scripts/train.py:327
    graph_aggr: str = "add"
    use_relation: bool = False
    use_orientation: bool = False
    use_distance: bool = False
    use_topdown: bool = False
    # input features
    use_color: bool = False
    use_normal: bool = False
    use_multiview: bool = False
    use_height: bool = True          # lib/dataset.py "not no_height"
    no_caption: bool = False
    min_iou: float = 0.25            # CONF.TRAIN.MIN_IOU_THRESHOLD (caption gate)

    @property
    def input_feature_dim(self) -> int:
        d = int(self.use_height)
        d += 3 * int(self.use_color)
        d += 3 * int(self.use_normal)
        d += 128 * int(self.use_multiview)
        return d

    @property
    def num_des_steps(self) -> int:
        # sos + 30 words + eos = 32 slots
        return self.max_des_len + 2


def flagship_config(**overrides) -> ModelConfig:
    """The flagship serving configuration (``bench.py:701``): multiview +
    normal + height input (135 channels), 2 graph steps, top-down caption
    decoder, relation and orientation heads."""
    base = dict(num_graph_steps=2, num_locals=10, use_topdown=True,
                use_relation=True, use_orientation=True,
                use_normal=True, use_multiview=True)
    base.update(overrides)
    return ModelConfig(**base)
