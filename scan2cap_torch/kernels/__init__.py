"""Hand-written CUDA kernels for Hopper and their ctypes wrappers.

Each wrapper takes CUDA tensors only, checks device, dtype, shape and
contiguity, launches on ``torch.cuda.current_stream()``, raises on a
failed launch, and counts its launches in a plain integer attribute
(``<wrapper>.launches``).  The ops in ``scan2cap_torch.ops`` route CUDA
tensors here and CPU tensors to their plain PyTorch versions.
"""

from scan2cap_torch.kernels.ballquery import ball_query_cuda, ball_query_pack_cuda
from scan2cap_torch.kernels.fps import furthest_point_sample_cuda
from scan2cap_torch.kernels.gather import group_points_cuda
from scan2cap_torch.kernels.pack_probe import pack_probe_cuda, shift_probe_cuda

WRAPPERS = (furthest_point_sample_cuda, ball_query_cuda, ball_query_pack_cuda,
            group_points_cuda, pack_probe_cuda, shift_probe_cuda)


def reset_launch_counts() -> None:
    for w in WRAPPERS:
        w.launches = 0
    furthest_point_sample_cuda.streamed_launches = 0
    ball_query_cuda.lists_in_memory_launches = 0


def launch_counts() -> dict:
    """Every wrapper's count by its name, and the two variant counts."""
    counts = {w.__name__: w.launches for w in WRAPPERS}
    counts["fps_streamed"] = furthest_point_sample_cuda.streamed_launches
    counts["ball_query_lists_in_memory"] = \
        ball_query_cuda.lists_in_memory_launches
    return counts


__all__ = ["ball_query_cuda", "ball_query_pack_cuda",
           "furthest_point_sample_cuda", "group_points_cuda",
           "pack_probe_cuda", "shift_probe_cuda", "reset_launch_counts",
           "launch_counts", "WRAPPERS"]
