"""Carry Flax parameters into the port (the inverse of the tree paths that
``scan2cap_tpu/convert.py`` writes).

The port names every parameter after its Flax tree path, so the mapping is
mechanical: path components join with dots, a Dense ``kernel`` (in, out)
becomes a Linear ``weight`` (out, in), BatchNorm ``scale``/``bias`` become
``weight``/``bias``, and ``batch_stats`` ``mean``/``var`` become
``running_mean``/``running_var``.  The result loads with
``load_state_dict(strict=True)``.

A Flax gradient tree has the shape of ``params``, so ``named_from_flax``
gives it the port's parameter names too, and ``adam_state_from_optax``
carries the moments of the JAX package's optimizer (``add_decayed_weights``
+ ``scale_by_adam``) into a ``torch.optim.Adam``.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

_PARAM_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias"}
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
            if value.ndim != 2:
                raise ValueError(f"{'/'.join(path)}: expected a 2-D Dense "
                                 f"kernel, got shape {value.shape}")
            value = value.T
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
