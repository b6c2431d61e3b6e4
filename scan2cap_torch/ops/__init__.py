"""Point-cloud ops in PyTorch (counterpart of ``scan2cap_tpu/ops``).

Batched, channels-last.  FPS, the ball query and the row gather of
``group_points`` run as the custom ops of ``ops/library.py``, which
dispatch CUDA tensors to the hand-written kernels in
``scan2cap_torch.kernels`` and CPU tensors to their plain PyTorch
versions, which live beside them here.
"""

from scan2cap_torch.ops.boxes import (box3d_iou_batch, box3d_iou_matrix,
                                      get_3d_box_batch)
from scan2cap_torch.ops.grouping import (ball_query, group_all,
                                         group_points, query_and_group)
from scan2cap_torch.ops.nn_distance import huber_loss, nn_distance
from scan2cap_torch.ops.interpolate import (interpolation_weights,
                                            three_interpolate, three_nn)
from scan2cap_torch.ops.sampling import furthest_point_sample, gather_points
# registers the scan2cap:: custom ops that sampling and grouping call
from scan2cap_torch.ops import library  # noqa: F401

__all__ = [
    "furthest_point_sample", "gather_points", "ball_query",
    "group_points", "query_and_group", "group_all", "three_nn",
    "three_interpolate", "interpolation_weights", "get_3d_box_batch",
    "box3d_iou_matrix", "box3d_iou_batch", "nn_distance", "huber_loss",
]
