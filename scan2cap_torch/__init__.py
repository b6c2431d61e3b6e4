"""PyTorch/CUDA port of scan2cap_tpu for NVIDIA Hopper (H100).

The package mirrors ``scan2cap_tpu``'s module layout so each port module
has an obvious counterpart.  Ported: CapNet with both caption decoders
(``models``), its losses and the train and eval steps (``losses``,
``train``), the evaluation (``eval``: NMS and post-processing on the card,
the caption metrics and detection AP on the host), the ScanRefer dataset
and its native host data plane (``data``, ``native``), the solver and its
``torch.save`` checkpoints (``train``), the reference's ``.pth`` layout
both ways (``convert``), MaskVoteNet, the pretrained-feature track
(``models.capnet_pretrained``, ``data.dataset_pretrained``, the object
encoder and dataset) over a feature store that numpy alone reads
(``data.feature_store``), multiview features from RGB-D frames (ENet in
``models.enet``, ``data.projection``, ``data.frames``), the bfloat16
backbone (``ModelConfig.compute_dtype``, ``storage_dtype``,
``bf16_components``), ScanNet's preprocessing
(``data.scannet_preprocess``), ``--mesh DATA,MODEL`` and ``--spatial``
over ``torch.distributed`` (``parallel``), the 2D captioning baselines
over ResNet features of rendered views (``twod``), and the command-line
entry points under
``scan2cap_torch.scripts`` (the training-quality trajectory, the export to
a reference ``.pth``, the serving export through ``torch.export``, the
visualizer, the profiling reports and the dataset-preparation tools among
them) and ``scan2cap_torch.benchmark``.  It imports torch and numpy only
— never JAX, Flax or anything of ``scan2cap_tpu``; what it needs from there
it keeps as its own copy.  The TPU kernels of the JAX repository (furthest-point
sampling, the exact ball query, the row gather of ``group_points`` and the
two pack-tile probes) are hand-written CUDA under ``csrc/``, built with
``nvcc`` at first use (``kernels/_build.py``); the three that the model
runs are the ``torch.library`` custom ops of ``ops/library.py``.

Entry points run on the card: they take an explicit ``device`` that
defaults to ``"cuda"`` and raise when CUDA is missing unless the caller
passes ``device="cpu"`` (the tests do; on the CPU every kernel wrapper runs
its plain PyTorch version).
"""

import torch

# Full-precision float32 everywhere.  TF32 keeps ~10 mantissa bits: the JAX
# package found that reduced-precision distance products pick the wrong
# neighbours (scan2cap_tpu/ops/interpolate.py:36-41), and every index this
# port produces (FPS, ball query, 3-NN, graph top-k) must equal the
# reference's exactly.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# The bfloat16 backbone (``--bf16``) sums its products in float32 and
# rounds once, as the JAX package's bfloat16 Dense does: no split-K partial
# sums in bfloat16.
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

from scan2cap_torch.device import resolve_device  # noqa: E402

__all__ = ["resolve_device"]
