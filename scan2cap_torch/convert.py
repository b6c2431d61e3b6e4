"""Carry weights into the port: Flax trees and the reference's ``.pth``
layout, both ways.

The port names every parameter after its Flax tree path, so the mapping is
mechanical: path components join with dots, a Dense ``kernel`` (in, out)
becomes a Linear ``weight`` (out, in), a Conv2D ``kernel`` (kh, kw, in,
out) a Conv2d ``weight`` (out, in, kh, kw), BatchNorm ``scale``/``bias``
become ``weight``/``bias``, a PReLU's ``alpha`` its ``weight``, and
``batch_stats`` ``mean``/``var`` become ``running_mean``/``running_var``.
The result loads with ``load_state_dict(strict=True)``.

A Flax gradient tree has the shape of ``params``, so ``named_from_flax``
gives it the port's parameter names too, and ``adam_state_from_optax``
carries the moments of the JAX package's optimizer (``add_decayed_weights``
+ ``scale_by_adam``) into a ``torch.optim.Adam``.

The reference's layout (its released ``model.pth`` and VoteNet weights, and
what ``scripts/export_pth.py`` writes for a JAX run) goes through the Flax
tree: ``state_dict_from_reference`` maps the reference's keys to Flax paths
with a copy of ``scan2cap_tpu/convert.py``'s converter (1x1 convolutions
and Linear layers to Dense kernels, BN to scale/bias and statistics, the
GCN layouts, the caption heads by key presence, the vocabulary pad) and
then to the port's names with ``state_dict_from_flax``;
``reference_from_state_dict`` is the inverse, through ``flax_from_state_dict``
and a copy of the JAX package's exporter.  ``convert_enet_checkpoint`` takes
the reference's ENet (``scannetv2_enet.pth``) the same way, through a copy of
the JAX package's ENet converter.  No mapping is written twice.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

_PARAM_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
               "alpha": "weight"}
_STAT_LEAF = {"mean": "running_mean", "var": "running_var"}


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), np.asarray(v)


def named_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """A Flax tree shaped like ``params`` (the parameters, their gradients,
    an Adam moment) -> tensors by the port's parameter names, in the port's
    layouts."""
    sd: Dict[str, torch.Tensor] = {}
    for path, value in _leaves(tree):
        leaf = path[-1]
        if leaf not in _PARAM_LEAF:
            raise KeyError(f"unexpected Flax parameter leaf {'/'.join(path)}")
        if leaf == "kernel":
            if value.ndim == 4:                 # Conv2D (kh, kw, in, out)
                value = value.transpose(3, 2, 0, 1)
            elif value.ndim == 2:               # Dense (in, out)
                value = value.T
            else:
                raise ValueError(f"{'/'.join(path)}: expected a 2-D Dense "
                                 f"or 4-D Conv2D kernel, got shape "
                                 f"{value.shape}")
        key = ".".join(path[:-1] + (_PARAM_LEAF[leaf],))
        sd[key] = torch.from_numpy(np.array(value, np.float32, order="C"))
    return sd


def state_dict_from_flax(params: Mapping, batch_stats: Mapping | None = None
                         ) -> Dict[str, torch.Tensor]:
    """Flax ``params`` (+ ``batch_stats``) trees -> a port state_dict."""
    sd = named_from_flax(params)
    for path, value in _leaves(batch_stats or {}):
        leaf = path[-1]
        if leaf not in _STAT_LEAF:
            raise KeyError(f"unexpected Flax batch_stats leaf {'/'.join(path)}")
        key = ".".join(path[:-1] + (_STAT_LEAF[leaf],))
        sd[key] = torch.from_numpy(np.array(value, np.float32, order="C"))
    return sd


def adam_state_from_optax(opt_state, model: torch.nn.Module,
                          optimizer: torch.optim.Adam) -> None:
    """Load the state of the JAX package's optimizer into ``optimizer``.

    ``opt_state`` is the state of ``chain(add_decayed_weights,
    scale_by_adam)``: the element that has ``count``, ``mu`` and ``nu`` is
    found by those attributes.  ``optimizer`` must hold ``model``'s
    parameters; each gets ``step``, ``exp_avg`` and ``exp_avg_sq``."""
    adam = next((s for s in opt_state
                 if all(hasattr(s, a) for a in ("count", "mu", "nu"))), None)
    if adam is None:
        raise ValueError("no scale_by_adam state (count, mu, nu) in opt_state")
    mu, nu = named_from_flax(adam.mu), named_from_flax(adam.nu)
    count = float(np.asarray(adam.count))
    named = dict(model.named_parameters())
    if set(named) != set(mu):
        raise KeyError(f"optimizer state and model disagree on "
                       f"{sorted(set(named) ^ set(mu))[:5]}")
    for name, p in named.items():
        optimizer.state[p] = {
            "step": torch.tensor(count, dtype=torch.float32),
            "exp_avg": mu[name].to(p.device).clone(),
            "exp_avg_sq": nu[name].to(p.device).clone(),
        }


def flax_from_state_dict(sd: Mapping[str, torch.Tensor]
                         ) -> Tuple[dict, dict]:
    """The inverse of ``state_dict_from_flax``: a port state dict ->
    (params, batch_stats) Flax trees of numpy arrays.  A 2-D ``weight`` is a
    Linear's (a Dense kernel, transposed), a 4-D one a Conv2d's (a Conv2D
    kernel), and a 1-D one a PReLU's alpha when its module is named
    ``prelu*`` (as every PReLU of the port and the JAX package is), else a
    BatchNorm's scale, which must have its bias beside it."""
    params: dict = {}
    stats: dict = {}
    for key, value in sd.items():
        path = tuple(key.split("."))
        a = value.detach().cpu().numpy().astype(np.float32)
        leaf = path[-1]
        if leaf in ("running_mean", "running_var"):
            _set(stats, path[:-1] + (leaf[len("running_"):],), a)
        elif leaf == "weight" and a.ndim == 2:
            _set(params, path[:-1] + ("kernel",), a.T)
        elif leaf == "weight" and a.ndim == 4:
            _set(params, path[:-1] + ("kernel",), a.transpose(2, 3, 1, 0))
        elif leaf == "weight" and path[-2].startswith("prelu"):
            _set(params, path[:-1] + ("alpha",), a)
        elif leaf == "weight":
            if ".".join(path[:-1] + ("bias",)) not in sd:
                raise KeyError(f"{key}: a 1-D weight outside a prelu* module "
                               f"is a BatchNorm's scale and needs its bias")
            _set(params, path[:-1] + ("scale",), a)
        elif leaf == "bias":
            _set(params, path, a)
        else:
            raise KeyError(f"unexpected state dict entry {key}")
    return params, stats


# --- the reference's layout (a copy of scan2cap_tpu/convert.py:36-281, 411-594)

def load_reference(path_or_sd) -> Dict[str, np.ndarray]:
    """A reference-layout state dict as numpy arrays, from a ``.pth`` path
    (read with ``torch.load(weights_only=True)``) or from a dict of tensors
    or arrays; ``num_batches_tracked`` is dropped."""
    sd = path_or_sd
    if isinstance(sd, (str, os.PathLike)):
        sd = torch.load(sd, map_location="cpu", weights_only=True)
    return {k: (v.detach().cpu().numpy() if torch.is_tensor(v)
                else np.asarray(v))
            for k, v in sd.items() if not k.endswith("num_batches_tracked")}


def _conv_kernel(w: np.ndarray) -> np.ndarray:
    """(out, in, 1[, 1]) -> (in, out)."""
    return w.reshape(w.shape[0], w.shape[1]).T.copy()


def _set(tree: dict, path: Tuple[str, ...], value: np.ndarray):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = np.asarray(value, np.float32)


def _convert_shared_mlp(sd, prefix, params, stats, base):
    j = 0
    while f"{prefix}.layer{j}.conv.weight" in sd:
        _set(params, base + (f"dense_{j}", "kernel"),
             _conv_kernel(sd[f"{prefix}.layer{j}.conv.weight"]))
        if f"{prefix}.layer{j}.conv.bias" in sd:
            _set(params, base + (f"dense_{j}", "bias"),
                 sd[f"{prefix}.layer{j}.conv.bias"])
        bn = f"{prefix}.layer{j}.bn.bn"
        _set(params, base + (f"bn_{j}", "scale"), sd[bn + ".weight"])
        _set(params, base + (f"bn_{j}", "bias"), sd[bn + ".bias"])
        _set(stats, base + (f"bn_{j}", "mean"), sd[bn + ".running_mean"])
        _set(stats, base + (f"bn_{j}", "var"), sd[bn + ".running_var"])
        j += 1
    if j == 0:
        raise KeyError(f"no SharedMLP layers under {prefix}")


def _convert_bn(sd, prefix, params, stats, base):
    _set(params, base + ("scale",), sd[prefix + ".weight"])
    _set(params, base + ("bias",), sd[prefix + ".bias"])
    _set(stats, base + ("mean",), sd[prefix + ".running_mean"])
    _set(stats, base + ("var",), sd[prefix + ".running_var"])


def _convert_conv(sd, prefix, params, base):
    _set(params, base + ("kernel",), _conv_kernel(sd[prefix + ".weight"]))
    if prefix + ".bias" in sd:
        _set(params, base + ("bias",), sd[prefix + ".bias"])


def _convert_detection_tree(sd: Dict[str, np.ndarray]) -> Tuple[dict, dict]:
    params: dict = {}
    stats: dict = {}

    for i in (1, 2, 3, 4):
        _convert_shared_mlp(sd, f"backbone_net.sa{i}.mlp_module",
                            params, stats, ("backbone_net", f"sa{i}", "mlp"))
    for i in (1, 2):
        _convert_shared_mlp(sd, f"backbone_net.fp{i}.mlp",
                            params, stats, ("backbone_net", f"fp{i}", "mlp"))

    for k in (1, 2, 3):
        _convert_conv(sd, f"vgen.conv{k}", params, ("vgen", f"conv{k}"))
    for k in (1, 2):
        _convert_bn(sd, f"vgen.bn{k}", params, stats, ("vgen", f"bn{k}"))

    _convert_shared_mlp(sd, "proposal.vote_aggregation.mlp_module",
                        params, stats,
                        ("proposal", "vote_aggregation", "mlp"))
    _convert_conv(sd, "proposal.proposal.0", params, ("proposal", "conv1"))
    _convert_bn(sd, "proposal.proposal.1", params, stats, ("proposal", "bn1"))
    _convert_conv(sd, "proposal.proposal.3", params, ("proposal", "conv2"))
    _convert_bn(sd, "proposal.proposal.4", params, stats, ("proposal", "bn2"))
    _convert_conv(sd, "proposal.proposal.6", params, ("proposal", "conv3"))
    return params, stats


def _convert_linear(sd, prefix, params, base):
    """torch nn.Linear weight (out, in) -> Dense kernel (in, out)."""
    _set(params, base + ("kernel",),
         np.ascontiguousarray(sd[prefix + ".weight"].T))
    if prefix + ".bias" in sd:
        _set(params, base + ("bias",), sd[prefix + ".bias"])


def _convert_gru(sd, prefix, params, base):
    """torch nn.GRUCell -> models/layers.GRUCell (ih/hh Dense pairs).

    Both sides fuse the three gates on the output axis in the same (r, z, n)
    order (torch.nn.GRUCell docs; models/layers.py GRUCell), so the fused
    matrices transpose directly."""
    _set(params, base + ("ih", "kernel"), sd[prefix + ".weight_ih"].T)
    _set(params, base + ("ih", "bias"), sd[prefix + ".bias_ih"])
    _set(params, base + ("hh", "kernel"), sd[prefix + ".weight_hh"].T)
    _set(params, base + ("hh", "bias"), sd[prefix + ".bias_hh"])


def convert_graph_module(sd: Dict[str, np.ndarray], params: dict) -> int:
    """GraphModule weights (reference models/graph_module.py:132-152):
    ``graph.gc_layers.{i}`` is an EdgeConv (map_edge Sequential, Linear at
    indices 0 and 2) or a torch_geometric GCNConv (``lin`` + separate
    ``bias``); ``graph.edge_layer``/``graph.edge_predict`` exist when
    return_orientation.  Returns the number of graph layers found."""
    i = 0
    while True:
        base = ("graph", f"gc_{i}")
        if f"graph.gc_layers.{i}.map_edge.0.weight" in sd:       # EdgeConv
            _convert_linear(sd, f"graph.gc_layers.{i}.map_edge.0",
                            params, base + ("map_edge_0",))
            _convert_linear(sd, f"graph.gc_layers.{i}.map_edge.2",
                            params, base + ("map_edge_1",))
        elif f"graph.gc_layers.{i}.lin.weight" in sd:            # GCNConv
            _convert_linear(sd, f"graph.gc_layers.{i}.lin",
                            params, base + ("lin",))
            out = sd[f"graph.gc_layers.{i}.lin.weight"].shape[0]
            # PyG's internal lin carries no bias; GCNConvDense's does
            _set(params, base + ("lin", "bias"), np.zeros(out, np.float32))
            _set(params, base + ("bias",),
                 sd[f"graph.gc_layers.{i}.bias"])
        elif f"graph.gc_layers.{i}.weight" in sd:
            # legacy torch_geometric (<=1.6, the reference's era) stored
            # GCNConv.weight directly as (in_channels, out_channels)
            w = sd[f"graph.gc_layers.{i}.weight"]
            _set(params, base + ("lin", "kernel"), w)
            _set(params, base + ("lin", "bias"),
                 np.zeros(w.shape[1], np.float32))
            _set(params, base + ("bias",),
                 sd[f"graph.gc_layers.{i}.bias"])
        else:
            break
        i += 1
    if i == 0:
        raise KeyError("no graph.gc_layers.* in state_dict")
    if "graph.edge_layer.map_edge.0.weight" in sd:
        _convert_linear(sd, "graph.edge_layer.map_edge.0",
                        params, ("graph", "edge_layer", "map_edge_0"))
        _convert_linear(sd, "graph.edge_layer.map_edge.2",
                        params, ("graph", "edge_layer", "map_edge_1"))
        _convert_linear(sd, "graph.edge_predict",
                        params, ("graph", "edge_predict"))
    return i


def convert_caption_module(sd: Dict[str, np.ndarray], params: dict) -> str:
    """Caption decoder weights: TopDownSceneCaptionModule
    (reference models/caption_module.py:225-248) or the plain
    SceneCaptionModule (caption_module.py:40-65), detected by key presence.
    Returns which variant was found ("topdown" | "scene")."""
    if "caption.map_topdown.0.weight" in sd:
        _convert_linear(sd, "caption.map_topdown.0",
                        params, ("caption", "map_topdown"))
        _convert_gru(sd, "caption.recurrent_cell_1",
                     params, ("caption", "recurrent_cell_1"))
        for name in ("map_feat", "map_hidd", "attend"):
            _convert_linear(sd, f"caption.{name}", params, ("caption", name))
        _convert_linear(sd, "caption.map_lang.0",
                        params, ("caption", "map_lang"))
        _convert_gru(sd, "caption.recurrent_cell_2",
                     params, ("caption", "recurrent_cell_2"))
        variant = "topdown"
    elif "caption.map_feat.0.weight" in sd:
        _convert_linear(sd, "caption.map_feat.0",
                        params, ("caption", "map_feat"))
        _convert_gru(sd, "caption.recurrent_cell",
                     params, ("caption", "recurrent_cell"))
        variant = "scene"
    else:
        raise KeyError("no caption.* module in state_dict")
    _convert_linear(sd, "caption.classifier", params, ("caption", "classifier"))
    return variant


def convert_capnet_checkpoint(sd: Dict[str, np.ndarray],
                              num_vocabs_padded: Optional[int] = None
                              ) -> Tuple[dict, dict]:
    """Full Scan2Cap ``model.pth`` (numpy, ``load_reference``) ->
    (params, batch_stats) for CapNet: detection + graph + caption, each
    converted when present; ``num_vocabs_padded`` zero-pads the caption
    classifier to that width."""
    params, stats = _convert_detection_tree(sd)
    if any(k.startswith("graph.") for k in sd):
        convert_graph_module(sd, params)
    if any(k.startswith("caption.") for k in sd):
        convert_caption_module(sd, params)
        if num_vocabs_padded:
            params = pad_caption_classifier(params, num_vocabs_padded)
    return params, stats


def pad_caption_classifier(params: dict, num_vocabs_padded: int) -> dict:
    """Zero-pad the caption classifier's output dim to ``num_vocabs_padded``
    (a TP-friendly width from parallel.padded_vocab) so an unpadded
    checkpoint loads into a vocab-padded model.  Zero pad columns produce
    logit 0, which caption._mask_pad_logits overwrites with -1e30, so the
    padded model's loss and eval tokens match the unpadded model up to f32
    reassociation of the widened classifier gemm (last-ulp).  Returns a new
    tree (input params are not mutated)."""
    cap = params.get("caption")
    if not cap or "classifier" not in cap:
        raise KeyError("params carry no caption.classifier")
    k = np.asarray(cap["classifier"]["kernel"])
    b = np.asarray(cap["classifier"]["bias"])
    v = k.shape[1]
    if num_vocabs_padded < v:
        raise ValueError(f"num_vocabs_padded={num_vocabs_padded} < "
                         f"classifier width {v}")
    if num_vocabs_padded == v:
        return params
    pk = np.zeros((k.shape[0], num_vocabs_padded), k.dtype)
    pk[:, :v] = k
    pb = np.zeros((num_vocabs_padded,), b.dtype)
    pb[:v] = b
    out = dict(params)
    out["caption"] = dict(cap)
    out["caption"]["classifier"] = {"kernel": pk, "bias": pb}
    return out


def slice_caption_classifier(params: dict, num_vocabs: int) -> dict:
    """Inverse of pad_caption_classifier: cut a vocab-padded run's classifier
    back to the real vocabulary width (for export to the reference layout or
    for loading into an unpadded model).  Returns a new tree."""
    cap = params.get("caption")
    if not cap or "classifier" not in cap:
        raise KeyError("params carry no caption.classifier")
    k = np.asarray(cap["classifier"]["kernel"])
    b = np.asarray(cap["classifier"]["bias"])
    if num_vocabs > k.shape[1]:
        raise ValueError(f"num_vocabs={num_vocabs} > "
                         f"classifier width {k.shape[1]}")
    out = dict(params)
    out["caption"] = dict(cap)
    out["caption"]["classifier"] = {"kernel": np.ascontiguousarray(k[:, :num_vocabs]),
                                    "bias": np.ascontiguousarray(b[:num_vocabs])}
    return out


def _get(tree: dict, path: Tuple[str, ...]):
    return np.asarray(_get_node(tree, path))


def _dense_to_conv(k: np.ndarray, conv1d: bool) -> np.ndarray:
    """Dense kernel (in, out) -> torch conv weight (out, in, 1[, 1])."""
    w = np.ascontiguousarray(k.T)
    return w[..., None] if conv1d else w[..., None, None]


def export_votenet_checkpoint(params: dict, batch_stats: dict) -> dict:
    """Inverse of ``_convert_detection_tree``: emit the detection modules
    (backbone_net/vgen/proposal) as a torch state_dict in the reference's
    exact key layout (scripts/train.py:80-105 warm-start contract), so a
    model trained here can be loaded by the reference (or by this repo's
    own --use_pretrained path).  Returns the state_dict.
    """
    sd: dict = {}

    def put(key, arr, conv=None):
        a = np.asarray(arr, np.float32)
        if conv is not None:
            a = _dense_to_conv(a, conv1d=(conv == "1d"))
        sd[key] = torch.from_numpy(np.ascontiguousarray(a).copy())

    def put_mlp(prefix, base):
        j = 0
        while f"dense_{j}" in _get_node(params, base):
            put(f"{prefix}.layer{j}.conv.weight",
                _get(params, base + (f"dense_{j}", "kernel")), conv="2d")
            leaf = _get_node(params, base)[f"dense_{j}"]
            if "bias" in leaf:
                put(f"{prefix}.layer{j}.conv.bias", leaf["bias"])
            bn = f"{prefix}.layer{j}.bn.bn"
            put(bn + ".weight", _get(params, base + (f"bn_{j}", "scale")))
            put(bn + ".bias", _get(params, base + (f"bn_{j}", "bias")))
            put(bn + ".running_mean",
                _get(batch_stats, base + (f"bn_{j}", "mean")))
            put(bn + ".running_var",
                _get(batch_stats, base + (f"bn_{j}", "var")))
            sd[bn + ".num_batches_tracked"] = torch.zeros((), dtype=torch.long)
            j += 1

    def put_bn(prefix, base):
        put(prefix + ".weight", _get(params, base + ("scale",)))
        put(prefix + ".bias", _get(params, base + ("bias",)))
        put(prefix + ".running_mean", _get(batch_stats, base + ("mean",)))
        put(prefix + ".running_var", _get(batch_stats, base + ("var",)))
        sd[prefix + ".num_batches_tracked"] = torch.zeros((), dtype=torch.long)

    def put_conv(prefix, base):
        leaf = _get_node(params, base)
        put(prefix + ".weight", leaf["kernel"], conv="1d")
        if "bias" in leaf:
            put(prefix + ".bias", leaf["bias"])

    for i in (1, 2, 3, 4):
        put_mlp(f"backbone_net.sa{i}.mlp_module",
                ("backbone_net", f"sa{i}", "mlp"))
    for i in (1, 2):
        put_mlp(f"backbone_net.fp{i}.mlp", ("backbone_net", f"fp{i}", "mlp"))
    for k in (1, 2, 3):
        put_conv(f"vgen.conv{k}", ("vgen", f"conv{k}"))
    for k in (1, 2):
        put_bn(f"vgen.bn{k}", ("vgen", f"bn{k}"))
    put_mlp("proposal.vote_aggregation.mlp_module",
            ("proposal", "vote_aggregation", "mlp"))
    put_conv("proposal.proposal.0", ("proposal", "conv1"))
    put_bn("proposal.proposal.1", ("proposal", "bn1"))
    put_conv("proposal.proposal.3", ("proposal", "conv2"))
    put_bn("proposal.proposal.4", ("proposal", "bn2"))
    put_conv("proposal.proposal.6", ("proposal", "conv3"))

    return sd


def export_capnet_checkpoint(params: dict, batch_stats: dict,
                             num_vocabs: Optional[int] = None) -> dict:
    """Inverse of convert_capnet_checkpoint: emit a FULL ``model.pth``
    (detection + graph + caption) in the reference's exact key layout, so a
    model trained here can be loaded by the reference's eval/benchmark
    scripts (scripts/eval.py:106-108, benchmark/predict.py:102).

    ``num_vocabs``: when exporting a vocab-padded run (CapNet
    num_vocabs_padded), pass the real vocabulary size to slice the inert pad
    columns off the classifier so the .pth matches the reference width."""
    if num_vocabs is not None and "caption" in params:
        params = slice_caption_classifier(params, num_vocabs)

    sd = (export_votenet_checkpoint(params, batch_stats)
          if "backbone_net" in params else {})

    def put_linear(prefix, base):
        leaf = _get_node(params, base)
        w = np.ascontiguousarray(np.asarray(leaf["kernel"], np.float32).T)
        sd[prefix + ".weight"] = torch.from_numpy(w.copy())
        if "bias" in leaf:
            sd[prefix + ".bias"] = torch.from_numpy(
                np.asarray(leaf["bias"], np.float32).copy())

    def put_gru(prefix, base):
        for half in ("ih", "hh"):
            leaf = _get_node(params, base + (half,))
            sd[f"{prefix}.weight_{half}"] = torch.from_numpy(
                np.ascontiguousarray(np.asarray(leaf["kernel"], np.float32).T)
                .copy())
            sd[f"{prefix}.bias_{half}"] = torch.from_numpy(
                np.asarray(leaf["bias"], np.float32).copy())

    graph = params.get("graph", {})
    i = 0
    while f"gc_{i}" in graph:
        layer = graph[f"gc_{i}"]
        if "map_edge_0" in layer:                                 # EdgeConv
            put_linear(f"graph.gc_layers.{i}.map_edge.0",
                       ("graph", f"gc_{i}", "map_edge_0"))
            put_linear(f"graph.gc_layers.{i}.map_edge.2",
                       ("graph", f"gc_{i}", "map_edge_1"))
        else:                                                     # GCNConv
            # PyG's internal lin is bias-free: a nonzero Dense bias here
            # passes through the (input-dependent) degree normalization and
            # cannot be folded into GCNConv's post-norm bias exactly.
            lin_bias = np.asarray(layer["lin"].get("bias", np.zeros(1)))
            if np.abs(lin_bias).max() > 1e-6:
                raise ValueError(
                    f"graph.gc_{i}.lin has a nonzero bias; torch_geometric "
                    "GCNConv has no pre-normalization bias to map it onto")
            w = np.ascontiguousarray(
                np.asarray(layer["lin"]["kernel"], np.float32).T)
            sd[f"graph.gc_layers.{i}.lin.weight"] = torch.from_numpy(w.copy())
            sd[f"graph.gc_layers.{i}.bias"] = torch.from_numpy(
                np.asarray(layer["bias"], np.float32).copy())
        i += 1
    if "edge_layer" in graph:
        put_linear("graph.edge_layer.map_edge.0",
                   ("graph", "edge_layer", "map_edge_0"))
        put_linear("graph.edge_layer.map_edge.2",
                   ("graph", "edge_layer", "map_edge_1"))
        put_linear("graph.edge_predict", ("graph", "edge_predict"))

    caption = params.get("caption", {})
    if "map_topdown" in caption:                                  # TopDown
        put_linear("caption.map_topdown.0", ("caption", "map_topdown"))
        put_gru("caption.recurrent_cell_1", ("caption", "recurrent_cell_1"))
        for name in ("map_feat", "map_hidd", "attend"):
            put_linear(f"caption.{name}", ("caption", name))
        put_linear("caption.map_lang.0", ("caption", "map_lang"))
        put_gru("caption.recurrent_cell_2", ("caption", "recurrent_cell_2"))
    elif "recurrent_cell" in caption:                             # Scene
        put_linear("caption.map_feat.0", ("caption", "map_feat"))
        put_gru("caption.recurrent_cell", ("caption", "recurrent_cell"))
    if caption:
        put_linear("caption.classifier", ("caption", "classifier"))

    return sd


def _get_node(tree: dict, path: Tuple[str, ...]) -> dict:
    node = tree
    for p in path:
        node = node[p]
    return node


def state_dict_from_reference(sd, num_vocabs_padded: Optional[int] = None
                              ) -> Dict[str, torch.Tensor]:
    """A reference-layout state dict (a ``.pth`` path, or a dict of tensors
    or numpy arrays) -> the port's state dict, ready for
    ``load_state_dict(strict=True)`` of a CapNet with the same modules
    (detection, graph and caption, each when the file holds it)."""
    params, stats = convert_capnet_checkpoint(load_reference(sd),
                                              num_vocabs_padded)
    return state_dict_from_flax(params, stats)


def reference_from_state_dict(sd: Mapping[str, torch.Tensor],
                              num_vocabs: Optional[int] = None
                              ) -> Dict[str, torch.Tensor]:
    """The port's state dict -> the reference's layout (``model.pth``): the
    detection modules with ``num_batches_tracked`` zeros, the graph (a
    GCN ``lin`` with a nonzero bias is refused) and the caption head.
    ``num_vocabs`` cuts a vocabulary-padded classifier back to that width."""
    params, stats = flax_from_state_dict(sd)
    return export_capnet_checkpoint(params, stats, num_vocabs=num_vocabs)


DETECTION_MODULES = ("backbone_net", "vgen", "proposal")


def is_detection_only(sd) -> bool:
    """Whether a reference-layout state dict holds no caption head (a
    VoteNet ``.pth``)."""
    return not any(k.startswith("caption.") for k in sd)


def mount_detection_weights(model: torch.nn.Module, sd) -> None:
    """Load the detection modules (backbone_net, vgen, proposal) of a
    reference-layout state dict into ``model`` and leave the rest as it is
    (the reference mounts them by attribute, scripts/train.py:100-105).
    Every detection parameter and statistic of the model must be in the
    file."""
    params, stats = _convert_detection_tree(load_reference(sd))
    got = state_dict_from_flax(params, stats)
    own = {k for k in model.state_dict()
           if k.split(".")[0] in DETECTION_MODULES}
    if set(got) != own:
        raise KeyError(f"detection weights and model disagree on "
                       f"{sorted(set(got) ^ own)[:5]}")
    model.load_state_dict(got, strict=False)


# --- the reference's ENet (a copy of scan2cap_tpu/convert.py:285-382) ------
#
# The reference rebuilds a torch7-exported ENet as a flat nn.Sequential of 27
# top-level modules (lib/enet.py:130-694); its state dict keys:
#   0.0.{weight,bias}       initial 3->13 conv        (branch 1 = maxpool)
#   2.* / 3.weight          initial BN(16) / PReLU(16)
#   m in 4..25: one bottleneck each --
#     m.0.0.0.weight        proj conv (1x1, or 2x2/2 when downsampling)
#     m.0.0.1.* / 2.weight  bn1 / prelu1
#     regular/dilated:  m.0.0.3.{weight,bias} core 3x3 conv (with a bias),
#                       m.0.0.4.* bn2, 5 prelu2, 6 expand, 7 bn3
#     asymmetric:       m.0.0.3.weight 1x5 conv (no bias),
#                       m.0.0.4.{weight,bias} 5x1 conv (with a bias),
#                       m.0.0.5.* bn2, 6 prelu2, 7 expand, 8 bn3
#     m.2.weight            prelu_out
#   26.0.weight             1x1 classifier conv, no bias
# The port's convolutions before a BN are bias-free: a constant bias feeding
# a BN is absorbed by the batch mean in training and equals a shift of
# running_mean in eval, so the core convs' biases fold into running_mean.

_ENET_ASYMMETRIC = (False, False, True, False, False, False, True, False)


def _conv2d_kernel(w: np.ndarray) -> np.ndarray:
    """torch (out, in, kh, kw) -> Flax (kh, kw, in, out)."""
    return np.transpose(w, (2, 3, 1, 0)).copy()


def _convert_bn_folded(sd, prefix, params, stats, base, fold_bias=None):
    _set(params, base + ("scale",), sd[prefix + ".weight"])
    _set(params, base + ("bias",), sd[prefix + ".bias"])
    mean = sd[prefix + ".running_mean"]
    if fold_bias is not None:
        mean = mean - fold_bias
    _set(stats, base + ("mean",), mean)
    _set(stats, base + ("var",), sd[prefix + ".running_var"])


def _convert_enet_tree(sd: Dict[str, np.ndarray]) -> Tuple[dict, dict]:
    params: dict = {}
    stats: dict = {}
    _set(params, ("initial", "conv", "kernel"), _conv2d_kernel(sd["0.0.weight"]))
    _set(params, ("initial", "conv", "bias"), sd["0.0.bias"])
    _convert_bn_folded(sd, "2", params, stats, ("initial", "bn"))
    _set(params, ("initial", "prelu", "alpha"), sd["3.weight"])

    blocks = [(4 + i, f"b1_{i}", False) for i in range(5)]
    blocks += [(9, "b2_0", False)]
    blocks += [(10 + i, f"b2_{i + 1}", asym)
               for i, asym in enumerate(_ENET_ASYMMETRIC)]
    blocks += [(18 + i, f"b3_{i + 1}", asym)
               for i, asym in enumerate(_ENET_ASYMMETRIC)]
    for m, name, asym in blocks:
        pre = f"{m}.0.0"
        base = (name,)
        _set(params, base + ("proj", "kernel"),
             _conv2d_kernel(sd[f"{pre}.0.weight"]))
        _convert_bn_folded(sd, f"{pre}.1", params, stats, base + ("bn1",))
        _set(params, base + ("prelu1", "alpha"), sd[f"{pre}.2.weight"])
        if asym:
            _set(params, base + ("conv_a", "kernel"),
                 _conv2d_kernel(sd[f"{pre}.3.weight"]))
            _set(params, base + ("conv_b", "kernel"),
                 _conv2d_kernel(sd[f"{pre}.4.weight"]))
            core_bias = sd.get(f"{pre}.4.bias")
            off = 1
        else:
            _set(params, base + ("conv", "kernel"),
                 _conv2d_kernel(sd[f"{pre}.3.weight"]))
            core_bias = sd.get(f"{pre}.3.bias")
            off = 0
        _convert_bn_folded(sd, f"{pre}.{4 + off}", params, stats,
                           base + ("bn2",), fold_bias=core_bias)
        _set(params, base + ("prelu2", "alpha"), sd[f"{pre}.{5 + off}.weight"])
        _set(params, base + ("expand", "kernel"),
             _conv2d_kernel(sd[f"{pre}.{6 + off}.weight"]))
        _convert_bn_folded(sd, f"{pre}.{7 + off}", params, stats,
                           base + ("bn3",))
        _set(params, base + ("prelu_out", "alpha"), sd[f"{m}.2.weight"])
    return params, stats


def convert_enet_checkpoint(sd, include_classifier: bool = False
                            ) -> Dict[str, torch.Tensor]:
    """The reference's ``scannetv2_enet.pth`` (a path, or its state dict)
    -> a state dict of ``models.enet.ENetEncoder``, or with
    ``include_classifier`` of ``ENetClassifier``; it loads with
    ``load_state_dict(strict=True)``."""
    sd = load_reference(sd)
    params, stats = _convert_enet_tree(sd)
    if include_classifier:
        params = {"encoder": params,
                  "classifier": {"kernel": _conv2d_kernel(sd["26.0.weight"])}}
        stats = {"encoder": stats}
    return state_dict_from_flax(params, stats)


# --- the 2D baselines (scan2cap_torch/twod)
# The decoders' Flax parameters carry over with ``state_dict_from_flax``:
# ``twod.models`` names its modules after the Flax tree.


def resnet_state_dict(params: dict) -> Dict[str, torch.Tensor]:
    """``twod.resnet.convert_resnet_checkpoint``'s tree -> a state dict of
    ``twod.resnet.ResNet``: each HWIO kernel as a Conv2d weight (O, I, kh,
    kw) beside its folded scale and shift; it loads with
    ``load_state_dict(strict=True)``."""
    sd: Dict[str, torch.Tensor] = {}

    def conv(prefix: str, p: dict) -> None:
        sd[prefix + ".weight"] = torch.from_numpy(np.ascontiguousarray(
            np.asarray(p["kernel"], np.float32).transpose(3, 2, 0, 1)))
        for leaf in ("scale", "shift"):
            sd[f"{prefix}.{leaf}"] = torch.from_numpy(
                np.array(p[leaf], np.float32))

    conv("stem", params["stem"])
    for layer in (1, 2, 3, 4):
        for i, block in enumerate(params[f"layer{layer}"]):
            for name in ("conv1", "conv2", "conv3", "downsample"):
                if name in block:
                    conv(f"layer{layer}.{i}.{name}", block[name])
    return sd
