"""Shared NN primitives (counterpart of ``scan2cap_tpu/models/layers.py``).

Channels-last: the reference's 1x1 convolutions are ``nn.Linear`` over the
trailing axis.  Parameter names follow the Flax tree (``dense_{i}``,
``bn_{i}``, GRU ``ih``/``hh``) so ``convert.state_dict_from_flax`` is a
mechanical rename.

bfloat16 (``SharedMLP``'s ``compute_dtype`` and ``storage_dtype``) is cast
explicitly, tensor by tensor, where the JAX package's Flax modules narrow:
parameters and BN running statistics stay float32, and ``torch.autocast``
is not used.

Under a mesh (``parallel.mesh``), train-mode ``BatchNorm`` takes its
statistics over the global batch: the per-rank sums travel over the data
group with their gradients.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from scan2cap_torch.parallel import mesh as pmesh


def widen(x: torch.Tensor) -> torch.Tensor:
    """``x`` in at least float32 (a bfloat16 tensor promoted, as Flax
    promotes it against float32 parameters; float32 and float64 as they
    are)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


class BatchNorm(nn.Module):
    """Torch-semantics batch norm over the trailing feature axis, with the
    momentum passed per call (the BN momentum schedule is a call argument
    in the JAX package too).  Train mode normalises with the biased batch
    variance and updates the running variance with the unbiased one.  The
    statistics and ``(x - mean) * inv + bias`` are at least float32
    whatever ``x`` is; the result has ``x``'s dtype
    (``scan2cap_tpu/models/layers.py:22-51``).  Under a mesh the batch
    is the global one, and the running variance's correction counts its
    rows."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, train: bool = False,
                momentum: float = 0.1) -> torch.Tensor:
        xf = widen(x)
        if train:
            dims = tuple(range(x.dim() - 1))
            n = x.numel() // x.shape[-1]
            if pmesh.current() is None:
                mean = xf.mean(dim=dims)
                var = xf.var(dim=dims, unbiased=False)
            else:
                # global statistics: two passes, each sum over the data
                # group with its gradient (every rank's loss share
                # depends on them)
                n = pmesh.batch_count(n)
                mean = pmesh.sum_shares(xf.sum(dim=dims)) / n
                var = pmesh.sum_shares(
                    torch.sum((xf - mean) ** 2, dim=dims)) / n
            with torch.no_grad():
                unbiased = var * (n / max(n - 1, 1))
                self.running_mean.mul_(1.0 - momentum).add_(momentum * mean)
                self.running_var.mul_(1.0 - momentum).add_(momentum * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps) * self.weight
        return ((xf - mean) * inv + self.bias).to(x.dtype)


def torch_dtype(name: Optional[str]) -> Optional[torch.dtype]:
    """A dtype's name ("bfloat16") -> the torch dtype; None and "float32"
    (no narrowing) -> None."""
    if name is None or name == "float32":
        return None
    return getattr(torch, name)


class SharedMLP(nn.Module):
    """Stack of Linear(+BN)(+ReLU) over the trailing axis; ``features``
    lists the input width followed by the output widths.

    ``compute_dtype`` (a dtype's name, e.g. "bfloat16"): layers 1 and on
    cast their input and weight to it and multiply there (Flax's
    ``Dense(dtype=...)``).  Layer 0 always computes in float32: the SA
    layers' gather-lean split Dense(a + b) == Dense(a) + Dense(b) runs it
    over absolute room-scale coordinates, which bfloat16 would quantize.

    ``storage_dtype``: only the activations between layers are cast to it;
    every product and BN computes in float32 on them, and the last layer's
    output stays float32.  Ignored when ``compute_dtype`` is set."""

    def __init__(self, in_features: int, features: Sequence[int],
                 bn: bool = True, activation: bool = True,
                 compute_dtype: Optional[str] = None,
                 storage_dtype: Optional[str] = None):
        super().__init__()
        self.bn = bn
        self.activation = activation
        self.num_layers = len(features)
        self.compute_dtype = torch_dtype(compute_dtype)
        self.storage_dtype = (None if self.compute_dtype is not None
                              else torch_dtype(storage_dtype))
        widths = [in_features, *features]
        for i, w in enumerate(features):
            self.add_module(f"dense_{i}", nn.Linear(widths[i], w, bias=not bn))
            if bn:
                self.add_module(f"bn_{i}", BatchNorm(w))

    def _dense(self, x, i):
        lin = getattr(self, f"dense_{i}")
        dt = self.compute_dtype
        if i and dt is not None:
            # the product and the bias add in the narrow dtype, as Flax's
            # Dense(dtype=bfloat16) does
            y = F.linear(x.to(dt), lin.weight.to(dt))
            return y if lin.bias is None else y + lin.bias.to(dt)
        # a narrow input is promoted to the parameters' dtype, as in Flax
        return lin(x.to(lin.weight.dtype))

    def _post(self, x, i, train, bn_momentum):
        if self.bn:
            x = getattr(self, f"bn_{i}")(x, train, bn_momentum)
        if self.activation:
            x = torch.relu(x)
        if self.storage_dtype is not None and i < self.num_layers - 1:
            x = x.to(self.storage_dtype)
        return x

    def forward(self, x: torch.Tensor, train: bool = False,
                bn_momentum: float = 0.1) -> torch.Tensor:
        for i in range(self.num_layers):
            x = self._post(self._dense(x, i), i, train, bn_momentum)
        return x

    def project_first(self, x: torch.Tensor) -> torch.Tensor:
        """Layer-0 linear only (bias-free with BN), so callers may split
        Dense(a + b) == Dense(a) + Dense(b)."""
        if not self.bn:
            raise ValueError("project_first requires bn=True: with a bias the "
                             "linear decomposition drops it")
        return self.dense_0(x)

    def from_first(self, x: torch.Tensor, train: bool = False,
                   bn_momentum: float = 0.1) -> torch.Tensor:
        """Finish the stack from layer-0 pre-activation values."""
        x = self._post(x, 0, train, bn_momentum)
        for i in range(1, self.num_layers):
            x = self._post(self._dense(x, i), i, train, bn_momentum)
        return x


class GRUCell(nn.Module):
    """torch.nn.GRUCell semantics with the Flax layout: one fused (3H)
    input projection ``ih`` and one fused (3H) hidden projection ``hh``,
    gates in (r, z, n) order."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.hidden_size = hidden_size
        self.ih = nn.Linear(input_size, 3 * hidden_size)
        self.hh = nn.Linear(hidden_size, 3 * hidden_size)

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        i_r, i_z, i_n = self.ih(x).chunk(3, dim=-1)
        h_r, h_z, h_n = self.hh(h).chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        return (1.0 - z) * n + z * h


@torch.no_grad()
def seeded_init(model: nn.Module, seed: int) -> None:
    """Seeded random weights, the same on every device: drawn on the CPU
    from ``torch.Generator().manual_seed(seed)``, Linear and Conv2d weights
    N(0, 1/fan_in) and biases 0, BN scale 1 and shift 0."""
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            fan_in = m.weight[0].numel()
            m.weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=g)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, BatchNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
