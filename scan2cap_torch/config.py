"""Static model configuration (copy of ``scan2cap_tpu/config.py:27-227``).

Only what the ported paths read: ``ModelConfig``, the ScanNet class names,
nyu40 ids, mean-size table and mean colour, the numpy box decode the
dataset uses, and ``PathConfig``.  Field names and defaults are the JAX
package's, so a config written for one package reads the same in the other.
The backbone narrows to bfloat16 as the JAX package's does
(``compute_dtype``, ``storage_dtype``, gated per module by
``bf16_components``; ``models/layers.py``); ``spatial_axis`` names the
mesh axis the set-abstraction layers split their query axis over
(``parallel/spatial.py``, ``--spatial``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Tuple

import numpy as np

SCANNET_TYPE2CLASS = {
    "cabinet": 0, "bed": 1, "chair": 2, "sofa": 3, "table": 4, "door": 5,
    "window": 6, "bookshelf": 7, "picture": 8, "counter": 9, "desk": 10,
    "curtain": 11, "refrigerator": 12, "shower curtain": 13, "toilet": 14,
    "sink": 15, "bathtub": 16, "others": 17,
}
SCANNET_CLASS2TYPE = {v: k for k, v in SCANNET_TYPE2CLASS.items()}

# nyu40 ids kept for detection: all but wall (1), floor (2), ceiling (22)
SCANNET_NYU40IDS = np.array(
    [3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 23,
     24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40],
    dtype=np.int64,
)

MEAN_COLOR_RGB = np.array([109.8, 97.2, 83.8], dtype=np.float32)  # lib/dataset.py:29

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


def param2obb_batch(center, heading_class, heading_residual, size_class,
                    size_residual) -> np.ndarray:
    """(..., 3), (...,), (...,), (...,), (..., 3) -> (..., 7) oriented box
    (model_util_scannet.py:156-172) in numpy: ScanNet's heading is always 0
    and is negated; the size is the class's mean plus the residual."""
    heading = np.zeros(np.asarray(heading_class).shape, dtype=np.float32)
    size = SCANNET_MEAN_SIZE_ARR[np.asarray(size_class)] + size_residual
    return np.concatenate(
        [center, size, (-heading)[..., None]], axis=-1).astype(np.float32)


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
    # numerics: the backbone's MLP chain computes in ``compute_dtype``
    # (its layers 1 and on; the geometry and layer 0 stay float32)
    compute_dtype: str = "float32"
    # storage-only narrowing: the backbone MLPs' inter-layer activations
    # are stored at this width while every matmul and BN computes in
    # float32 (ignored where compute_dtype narrows)
    storage_dtype: str = "float32"
    # which backbone modules either narrowing applies to
    bf16_components: str = "sa1,sa2,sa3,sa4,fp"
    # point-axis (spatial) sharding: the mesh axis ("model" or "data") the
    # SA layers' query centres split over (parallel/spatial.py); "" = off
    spatial_axis: str = ""

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


@dataclasses.dataclass(frozen=True)
class PathConfig:
    """Where the data and the runs lie: ``SCAN2CAP_BASE`` (default the
    working directory), ``SCAN2CAP_DATA`` (default ``<base>/data``) and
    ``SCAN2CAP_OUTPUT`` (default ``<base>/outputs``)."""

    base: str = dataclasses.field(
        default_factory=lambda: os.environ.get("SCAN2CAP_BASE", os.getcwd()))

    @property
    def data(self) -> str:
        return os.environ.get("SCAN2CAP_DATA", os.path.join(self.base, "data"))

    @property
    def scannet_data(self) -> str:
        return os.path.join(self.data, "scannet", "scannet_data")

    @property
    def scannet_meta(self) -> str:
        return os.path.join(self.data, "scannet", "meta_data")

    @property
    def multiview(self) -> str:
        """The multiview features: the port's store
        (``enet_feats_maxpool.npz``, ``data/feature_store.py``) where it
        exists, else the JAX package's HDF5 file, which needs ``h5py``."""
        store = os.path.join(self.scannet_data, "enet_feats_maxpool.npz")
        if os.path.exists(store):
            return store
        return os.path.join(self.scannet_data, "enet_feats_maxpool.hdf5")

    @property
    def glove(self) -> str:
        return os.path.join(self.data, "glove.p")

    @property
    def output(self) -> str:
        return os.environ.get("SCAN2CAP_OUTPUT",
                              os.path.join(self.base, "outputs"))
