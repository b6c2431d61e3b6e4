"""Point-axis (spatial) sharding of the set-abstraction layers (counterpart
of ``scan2cap_tpu/parallel/spatial.py``).

Every query centre's ball query and grouping is independent of the other
centres, so the QUERY axis (M) splits over a mesh axis while the source
cloud stays replicated: each rank of the axis's group scans its
contiguous M / size centres over all N points of its scenes, and the
shares are gathered back along M (``mesh.gather``: its gradient is the
rank's own slice).  In the backward, the gradient of every replicated
input (the feature table, the sa1 projection's ``cat`` and ``w0``) is
summed over the group (``mesh.enter``): that is the psum that
``shard_map``'s transpose inserts in the JAX package.

FPS is not sharded: a serial scan whose every step would need a
cross-rank argmax.  Every rank computes the same indices from the
replicated cloud.

The scene axis: a rank holds its data shard's scenes only, so the query
axis may ride either group; over the data group (``axis="data"``) the
inputs must be the same on every rank of it, and the scenes are then not
also split (``_batch_axis`` of the JAX package).

The kernels take contiguous tensors: each share is copied out
(``M / size`` x 3 floats, or the index rows) before it reaches them.
Exact: sharded == unsharded index for index.
"""

from __future__ import annotations

from typing import Optional

import torch

from scan2cap_torch.ops.grouping import ball_query, group_points
from scan2cap_torch.parallel import mesh as pmesh


def _resolve(axis: str) -> pmesh.Mesh:
    mesh = pmesh.current()
    if mesh is None or axis not in ("data", "model"):
        raise ValueError(
            f"spatial sharding over axis {axis!r} needs a mesh with that "
            f"axis (run under --mesh DATA,MODEL); current mesh is {mesh}")
    return mesh


def _share(x: torch.Tensor, axis: str) -> torch.Tensor:
    """This rank's contiguous share of axis 1 (the query axis)."""
    mesh = _resolve(axis)
    M, size = x.shape[1], mesh.size(axis)
    assert M % size == 0, (M, size)
    return pmesh.shard_of(x, axis, 1).contiguous()


def ball_query_sharded(xyz: torch.Tensor, new_xyz: torch.Tensor,
                       radius: float, nsample: int,
                       axis: str = "model") -> torch.Tensor:
    """Exact ball query with the query axis split over ``axis``: xyz
    (B, N, 3) replicated over the group, new_xyz (B, M, 3) with M
    divisible by its size -> (B, M, nsample) int32, the unsharded op's."""
    idx = ball_query(xyz, _share(new_xyz, axis), radius, nsample)
    return pmesh.all_gather(idx, axis, 1)


def group_points_sharded(features: torch.Tensor, idx: torch.Tensor,
                         axis: str = "model") -> torch.Tensor:
    """Neighbourhood gather with the query axis of ``idx`` split over
    ``axis``; the table is replicated.  (B, N, C), (B, M, S) ->
    (B, M, S, C)."""
    part = group_points(pmesh.enter(features, axis), _share(idx, axis))
    return pmesh.gather(part, axis, 1)


def leaf_gathered_projection_sharded(lgp_fn, cat: torch.Tensor,
                                     ct_in: torch.Tensor, w0: torch.Tensor,
                                     idx: torch.Tensor,
                                     axis: str = "model") -> torch.Tensor:
    """The backbone's scatter-free sa1 projection
    (``models/backbone.leaf_gathered_projection``, passed in as ``lgp_fn``)
    on this rank's queries: ct_in (B, M, Cin) and idx (B, M, S) split,
    cat (B, N, Cin) and w0 (Cin, D) replicated; w0's gradient is summed
    over the group."""
    part = lgp_fn(pmesh.enter(cat, axis), _share(ct_in, axis),
                  pmesh.enter(w0, axis), _share(idx, axis))
    return pmesh.gather(part, axis, 1)


def query_and_group_sharded(xyz: torch.Tensor, new_xyz: torch.Tensor,
                            features: Optional[torch.Tensor], radius: float,
                            nsample: int, axis: str = "model",
                            use_xyz: bool = True,
                            normalize_xyz: bool = False) -> torch.Tensor:
    """``ops.grouping.query_and_group`` with the query axis split over
    ``axis``."""
    idx = ball_query_sharded(xyz, new_xyz, radius, nsample, axis)
    grouped_xyz = group_points_sharded(xyz, idx, axis) \
        - new_xyz[:, :, None, :]
    if normalize_xyz:
        grouped_xyz = grouped_xyz / radius
    if features is None:
        if not use_xyz:
            raise ValueError("cannot have no features and use_xyz=False")
        return grouped_xyz
    grouped_features = group_points_sharded(features, idx, axis)
    if use_xyz:
        return torch.cat([grouped_xyz, grouped_features], dim=-1)
    return grouped_features
