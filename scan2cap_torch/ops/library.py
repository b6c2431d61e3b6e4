"""The three kernels of the model's path as ``torch.library`` custom ops.

  * ``scan2cap::furthest_point_sample(xyz, npoint)``: (B, N, 3) float32 ->
    (B, npoint) int32;
  * ``scan2cap::ball_query(xyz, new_xyz, radius, nsample)``: (B, N, 3),
    (B, M, 3) -> (B, M, nsample) int32, the first-k at every nsample (the
    fused scan up to 256, the ordered scan above);
  * ``scan2cap::group_points(features, idx)``: (B, N, C), (B, M, S) ->
    (B, M, S, C), with its gradient in ``features`` (a scatter-add of the
    output's gradient into the table, ``index_add_``).

Each op has a CUDA implementation that calls the hand-written kernel's
wrapper, a CPU implementation that is the plain PyTorch version, and a
fake implementation that gives the output's shape and dtype, so that
``torch.export`` traces a model through them and a saved program calls
them again when it runs.  ``ops.sampling`` and ``ops.grouping`` call these
ops, so the model has one route to each kernel.

The implementations are registered on the dispatch keys themselves
(``Library.impl``), not through ``torch.library.custom_op``, whose
wrappers import ``torch._dynamo`` at an op's first call: seconds of a
process's first forward.

The CUDA implementations look the wrappers up through ``ops.sampling`` and
``ops.grouping`` at each call, not at import, so that whatever stands in
those modules' attributes (a wrapper that holds each launch against its
plain version) also serves a program loaded from disk.

Importing this module registers the ops; a program exported from the port
needs it imported before ``torch.export.load``.
"""

from __future__ import annotations

import torch

from scan2cap_torch.ops import grouping, sampling

_LIB = torch.library.Library("scan2cap", "DEF")
_LIB.define("furthest_point_sample(Tensor xyz, int npoint) -> Tensor")
_LIB.define("ball_query(Tensor xyz, Tensor new_xyz, float radius, "
            "int nsample) -> Tensor")
_LIB.define("group_points(Tensor features, Tensor idx) -> Tensor")


# While ``models.stage_graph`` captures a stage as CUDA graph segments,
# its function that cuts the segment under capture at an FPS or
# ball-query launch (None otherwise): the launch runs eager between two
# segments, here and at every replay, so it stays a call of the wrappers
# that ``ops.sampling`` and ``ops.grouping`` hold.  A module variable, as
# a capture is one per process: the ops are registered at import, before
# any capture exists.
cut = None


def _impl(name: str, key: str):
    def register(fn):
        _LIB.impl(name, fn, key)
        return fn
    return register


def _fake(name: str):
    return torch.library.register_fake(f"scan2cap::{name}", lib=_LIB)


@_impl("furthest_point_sample", "CPU")
def _fps_cpu(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    return sampling.furthest_point_sample_plain(xyz, npoint)


@_impl("furthest_point_sample", "CUDA")
def _fps_cuda(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    if cut is not None:
        return cut(torch.ops.scan2cap.furthest_point_sample.default, xyz,
                   npoint)
    # no cast: the kernel takes float32 alone and refuses the rest
    return sampling.furthest_point_sample_cuda(xyz.contiguous(), npoint)


@_fake("furthest_point_sample")
def _(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    return xyz.new_empty((xyz.shape[0], npoint), dtype=torch.int32)


@_impl("ball_query", "CPU")
def _ball_query_cpu(xyz: torch.Tensor, new_xyz: torch.Tensor,
                    radius: float, nsample: int) -> torch.Tensor:
    return grouping.ball_query_plain(xyz, new_xyz, radius, nsample)


@_impl("ball_query", "CUDA")
def _ball_query_cuda(xyz: torch.Tensor, new_xyz: torch.Tensor,
                     radius: float, nsample: int) -> torch.Tensor:
    if cut is not None:
        return cut(torch.ops.scan2cap.ball_query.default, xyz, new_xyz,
                   radius, nsample)
    return grouping.ball_query_cuda(xyz.contiguous(), new_xyz.contiguous(),
                                    grouping.radius_squared(radius), nsample)


@_fake("ball_query")
def _(xyz: torch.Tensor, new_xyz: torch.Tensor, radius: float,
      nsample: int) -> torch.Tensor:
    return xyz.new_empty((new_xyz.shape[0], new_xyz.shape[1], nsample),
                         dtype=torch.int32)


@_impl("group_points", "CPU")
def _group_points_cpu(features: torch.Tensor, idx: torch.Tensor
                      ) -> torch.Tensor:
    return grouping.group_points_plain(features, idx)


@_impl("group_points", "CUDA")
def _group_points_cuda(features: torch.Tensor, idx: torch.Tensor
                       ) -> torch.Tensor:
    return grouping.group_points_cuda(features.contiguous(),
                                      idx.to(torch.int32).contiguous())


@_fake("group_points")
def _(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return features.new_empty((*idx.shape, features.shape[-1]))


def _group_points_setup(ctx, inputs, output) -> None:
    features, idx = inputs
    ctx.save_for_backward(idx)
    ctx.table_shape = features.shape


def _group_points_backward(ctx, grad):
    """The scatter-add of the gradient into the table; on CUDA its atomics
    sum in no fixed order, so it is not bit-stable between runs."""
    (idx,) = ctx.saved_tensors
    B, N, C = ctx.table_shape
    rows = idx.reshape(B, -1).long() + N * torch.arange(
        B, device=idx.device)[:, None]
    table = grad.new_zeros((B * N, C))
    table.index_add_(0, rows.reshape(-1), grad.reshape(-1, C))
    return table.reshape(B, N, C), None


torch.library.register_autograd("scan2cap::group_points",
                                _group_points_backward,
                                setup_context=_group_points_setup, lib=_LIB)
