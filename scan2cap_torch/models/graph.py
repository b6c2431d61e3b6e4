"""Relational graph module (counterpart of ``scan2cap_tpu/models/graph.py``;
reference models/graph_module.py).

Dense and masked: each proposal has exactly ``num_locals`` neighbour slots,
neighbours sorted by ascending proposal index (the reference's coo edge
order), messages MLP([x_j, x_i - x_j]) aggregated at the neighbour
(torch_geometric flow source_to_target), invalid proposals zeroed after
the graph.  Ties between equal distances (all masked neighbours sit at
1e30) go to the lower index, as ``lax.top_k`` does — hence a stable sort,
never ``torch.topk``.  The aggregation is ``index_add_``, which on CUDA sums
in a nondeterministic order: compare its outputs with a float tolerance.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from scan2cap_torch.ops.boxes import box3d_iou_matrix
from scan2cap_torch.ops.distance import sq_dist_reduce


def bbox_centers(corners: torch.Tensor) -> torch.Tensor:
    """(..., 8, 3) -> (..., 3) AABB centre (graph_module.py:176-180)."""
    return (corners.amin(dim=-2) + corners.amax(dim=-2)) / 2.0


def norm3(diff: torch.Tensor) -> torch.Tensor:
    """sqrt(jnp.sum(diff**2, -1) + 1e-8) with the JAX op's rounding."""
    return torch.sqrt(sq_dist_reduce(diff[..., 0], diff[..., 1],
                                     diff[..., 2]) + 1e-8)


def mask_and_topk_locals(dist: torch.Tensor, invalid: torch.Tensor,
                         iou: torch.Tensor, self_mask: torch.Tensor,
                         num_locals: int, overlay_threshold: float,
                         include_self: bool = True) -> torch.Tensor:
    """The locality rule (caption_module.py:322-363 == graph_module.py:182-222):
    invalid neighbours and overlapping boxes (IoU >= threshold) -> 1e30, the
    self slot -> 0 (include_self) or 1e30, then the ``num_locals`` smallest
    distances, ties to the lower index.  The fills are Python scalars: a
    tensor made on the host would be a copy to the card each call."""
    dist = torch.where(invalid, 1e30, dist)
    dist = torch.where(iou >= overlay_threshold, 1e30, dist)
    dist = torch.where(self_mask, 0.0 if include_self else 1e30, dist)
    order = torch.sort(dist, dim=-1, stable=True).indices
    return order[..., :num_locals]


def query_locals_dense(corners: torch.Tensor, object_masks: torch.Tensor,
                       num_locals: int, query_mode: str = "center",
                       include_self: bool = True,
                       overlay_threshold: float = 0.5
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-targets _query_locals (graph_module.py:182-222).

    Returns local_masks (B, K, K) float 0/1 and nbr_idx (B, K, L) int32,
    each row's neighbours in ascending proposal order."""
    B, K = object_masks.shape
    corners = corners.detach()          # only indices and 0/1 masks come out
    centers = bbox_centers(corners)                                  # (B,K,3)
    if query_mode == "center":
        dist = norm3(centers[:, :, None, :] - centers[:, None, :, :])
    elif query_mode == "corner":
        dist = norm3(corners[:, :, :, None, :]
                      - centers[:, None, None, :, :]).amin(dim=2)
    else:
        raise ValueError(f"invalid query_mode {query_mode}")
    iou = box3d_iou_matrix(corners, corners)                         # (B,K,K)
    eye = torch.eye(K, dtype=torch.bool, device=corners.device)[None]
    topk = mask_and_topk_locals(dist, (object_masks == 0)[:, None, :], iou,
                                eye, num_locals, overlay_threshold,
                                include_self)                        # (B,K,L)
    local_masks = torch.zeros((B, K, K), dtype=torch.float32,
                              device=corners.device)
    local_masks.scatter_(2, topk, 1.0)
    # the L selected ids are distinct: ascending order is their sort
    nbr_idx = torch.sort(topk, dim=-1).values.to(torch.int32)
    return local_masks, nbr_idx


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, K, C), idx (B, K, L) -> (B, K, L, C)."""
    B, K, L = idx.shape
    C = x.shape[-1]
    flat = idx.reshape(B, K * L).long()
    return torch.gather(x, 1, flat[..., None].expand(-1, -1, C)).reshape(
        B, K, L, C)


class EdgeConvDense(nn.Module):
    """EdgeConv message MLP (graph_module.py:22-115) over a dense edge list."""

    def __init__(self, in_size: int, out_size: int, aggregation: str = "add"):
        super().__init__()
        self.out_size = out_size
        self.aggregation = aggregation
        self.map_edge_0 = nn.Linear(2 * in_size, out_size)
        self.map_edge_1 = nn.Linear(out_size, out_size)

    def forward(self, x: torch.Tensor, nbr_idx: torch.Tensor,
                edge_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (B, K, C), nbr_idx (B, K, L), edge_mask (B, K, L) ->
        node_out (B, K, out), messages (B, K, L, out)."""
        B, K, _ = x.shape
        L = nbr_idx.shape[-1]
        x_tgt = _gather_rows(x, nbr_idx)                             # x_j
        x_src = x[:, :, None, :]                                     # x_i
        edge_in = torch.cat([x_tgt, x_src - x_tgt], dim=-1)
        messages = self.map_edge_1(torch.relu(self.map_edge_0(edge_in)))
        messages = messages * edge_mask[..., None]
        seg = (nbr_idx.long() + (torch.arange(B, device=x.device) * K)[:, None, None]
               ).reshape(-1)
        node_out = messages.new_zeros((B * K, self.out_size))
        node_out.index_add_(0, seg, messages.reshape(B * K * L, self.out_size))
        node_out = node_out.reshape(B, K, self.out_size)
        if self.aggregation == "mean":
            cnt = edge_mask.new_zeros(B * K).index_add_(0, seg,
                                                        edge_mask.reshape(-1))
            node_out = node_out / torch.clamp(cnt, min=1.0).reshape(B, K, 1)
        return node_out, messages


class GCNConvDense(nn.Module):
    """Dense GCNConv (torch_geometric semantics: self loops on valid
    nodes, in-degree d^-1/2 normalisation at both ends)."""

    def __init__(self, in_size: int, out_size: int):
        super().__init__()
        self.lin = nn.Linear(in_size, out_size)
        self.bias = nn.Parameter(torch.zeros(out_size))

    def forward(self, x: torch.Tensor, adj: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
        K = x.shape[1]
        a = adj * valid[:, :, None] * valid[:, None, :]
        a = a + torch.eye(K, device=x.device)[None] * valid[:, :, None]
        inv_sqrt = torch.rsqrt(torch.clamp(a.sum(dim=1), min=1e-12))
        norm = (inv_sqrt[:, :, None] * inv_sqrt[:, None, :]) * a
        return torch.einsum("bij,bic->bjc", norm, self.lin(x)) + self.bias


class GraphModule(nn.Module):
    def __init__(self, in_size: int = 128, out_size: int = 128,
                 num_layers: int = 2, num_locals: int = 10,
                 query_mode: str = "center", graph_mode: str = "edge_conv",
                 graph_aggr: str = "add", return_orientation: bool = False,
                 num_bins: int = 6, overlay_threshold: float = 0.5):
        super().__init__()
        if num_locals < 1:
            # the JAX package's top_k refuses it too; a slice [:-1] of the
            # sorted neighbours would silently build another graph
            raise ValueError(f"the graph needs num_locals >= 1, got "
                             f"{num_locals}")
        self.out_size = out_size
        self.num_layers = num_layers
        self.num_locals = num_locals
        self.query_mode = query_mode
        self.graph_mode = graph_mode
        self.return_orientation = return_orientation
        self.num_bins = num_bins
        self.overlay_threshold = overlay_threshold
        for i in range(num_layers):
            width = in_size if i == 0 else out_size
            if graph_mode == "edge_conv":
                layer = EdgeConvDense(width, out_size, graph_aggr)
            elif graph_mode == "graph_conv":
                layer = GCNConvDense(width, out_size)
            else:
                raise ValueError(f"invalid graph_mode {graph_mode}")
            self.add_module(f"gc_{i}", layer)
        if return_orientation:
            # extra edge layer on the final node features (graph_module.py:291-293)
            self.edge_layer = EdgeConvDense(out_size, out_size, graph_aggr)
            self.edge_predict = nn.Linear(out_size, num_bins + 1)

    def forward(self, data_dict: dict) -> dict:
        d = dict(data_dict)
        obj_feats = d["bbox_feature"]                                # (B,K,C)
        valid = d["bbox_mask"].to(torch.float32)                     # (B,K)
        B, K, _ = obj_feats.shape
        L = self.num_locals
        adjacent_mat, nbr_idx = query_locals_dense(
            d["bbox_corner"], valid, L, self.query_mode, include_self=False,
            overlay_threshold=self.overlay_threshold)
        nbr_valid = torch.gather(valid, 1, nbr_idx.reshape(B, K * L).long()
                                 ).reshape(B, K, L)
        edge_mask = valid[:, :, None] * nbr_valid                    # (B,K,L)

        feat = obj_feats
        messages = obj_feats.new_zeros((B, K, L, self.out_size))
        for i in range(self.num_layers):
            layer = getattr(self, f"gc_{i}")
            if self.graph_mode == "edge_conv":
                feat, messages = layer(feat, nbr_idx, edge_mask)
            else:
                feat = layer(feat, adjacent_mat, valid)

        if self.return_orientation:
            _, edge_msg = self.edge_layer(feat, nbr_idx, edge_mask)
            edge_pred = self.edge_predict(edge_msg)
            d["edge_orientations"] = edge_pred[..., :-1]
            d["edge_distances"] = edge_pred[..., -1]
        else:
            d["edge_orientations"] = obj_feats.new_zeros((B, K, L, self.num_bins))
            d["edge_distances"] = obj_feats.new_zeros((B, K, L))

        # skip connection + zero invalid nodes (graph_module.py:247,302-304)
        d["bbox_feature"] = (obj_feats + feat) * valid[..., None]
        d["adjacent_mat"] = adjacent_mat
        d["edge_feature"] = messages
        d["edge_nbr_idx"] = nbr_idx
        d["edge_mask"] = edge_mask
        return d
