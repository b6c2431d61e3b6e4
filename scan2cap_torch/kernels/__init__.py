"""Hand-written CUDA kernels for Hopper and their ctypes wrappers.

Each wrapper takes CUDA tensors only, checks device, dtype, shape and
contiguity, launches on ``torch.cuda.current_stream()``, raises on a
failed launch, and counts its launches in a plain integer attribute
(``<wrapper>.launches``).  The ops in ``scan2cap_torch.ops`` route CUDA
tensors here and CPU tensors to their plain PyTorch versions.
"""

from scan2cap_torch.kernels.ballquery import ball_query_cuda, ball_query_pack_cuda
from scan2cap_torch.kernels.fps import TIERS, furthest_point_sample_cuda
from scan2cap_torch.kernels.gather import group_points_cuda
from scan2cap_torch.kernels.pack_probe import pack_probe_cuda, shift_probe_cuda

WRAPPERS = (furthest_point_sample_cuda, ball_query_cuda, ball_query_pack_cuda,
            group_points_cuda, pack_probe_cuda, shift_probe_cuda)


def _counters() -> dict:
    """Each of ``launch_counts()``'s keys -> (wrapper, the attribute that
    counts it)."""
    counters = {w.__name__: (w, "launches") for w in WRAPPERS}
    for t in TIERS:
        counters[f"fps_{t}"] = (furthest_point_sample_cuda, f"{t}_launches")
    counters["ball_query_ordered"] = (ball_query_cuda, "ordered_launches")
    return counters


def reset_launch_counts() -> None:
    for w, attr in _counters().values():
        setattr(w, attr, 0)


def launch_counts() -> dict:
    """Every wrapper's count by its name, and the counts of the large-shape
    tiers: FPS in a 16-block cluster's registers, with shared-memory state,
    streamed; the ordered first-k (nsample above 256)."""
    return {k: getattr(w, attr) for k, (w, attr) in _counters().items()}


def add_launch_counts(delta: dict) -> None:
    """Add ``delta`` (some of ``launch_counts()``'s keys) to the counts:
    the launches that a CUDA graph replays, counted once at its capture."""
    counters = _counters()
    for k, n in delta.items():
        w, attr = counters[k]
        setattr(w, attr, getattr(w, attr) + n)


__all__ = ["ball_query_cuda", "ball_query_pack_cuda",
           "furthest_point_sample_cuda", "group_points_cuda",
           "pack_probe_cuda", "shift_probe_cuda", "reset_launch_counts",
           "launch_counts", "add_launch_counts", "WRAPPERS"]
