"""Seeded weights of a configuration, made on the device.

Every linear weight is N(0, 1/fan_in), drawn in one call for the whole
model; biases are 0, batch-norm scales 1 and shifts 0, running means 0
and variances 1.  The configuration's ``condition`` list then scales
named tensors, as no trained checkpoint is at hand: a fresh voting head
throws its votes metres away, so that no proposal would be a positive.
The state dict's names and shapes are the reference model's, which are
the port's.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from h100bench import kinds


def shapes(cfg: Dict) -> Dict[str, torch.Size]:
    """Name -> shape of every entry of the model's state dict."""
    with torch.device("meta"):
        m = kinds.of(cfg).reference(cfg)
    return {k: v.shape for k, v in m.state_dict().items()}


def make(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    g = torch.Generator(device=device).manual_seed(seed)
    shape = shapes(cfg)
    weights = [k for k, s in shape.items()
               if k.endswith(".weight") and len(s) == 2]
    flat = torch.randn(sum(shape[k].numel() for k in weights), generator=g,
                       device=device)
    out, at = {}, 0
    for k in weights:
        n = shape[k].numel()
        out[k] = (flat[at:at + n].reshape(shape[k])
                  / math.sqrt(shape[k][1]))
        at += n
    for k, s in shape.items():
        if k in out:
            continue
        fill = 1.0 if k.endswith((".weight", "running_var")) else 0.0
        out[k] = torch.full(s, fill, device=device)
    for name, factor in cfg.get("condition", ()):
        out[name] = out[name] * factor
    return out
