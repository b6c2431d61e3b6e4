"""ENet's encoder, the multiview feature trunk (counterpart of
``scan2cap_tpu/models/enet.py``; reference lib/enet.py).

  initial block: conv3x3/2 (13 channels) beside a 2x2 max-pool, 16 channels
  stage 1: a downsampling bottleneck 16 -> 64, then 4 regular ones
  stage 2: a downsampling bottleneck 64 -> 128, then the dilated and
           asymmetric sequence [reg, dil2, asym5, dil4, reg, dil8, asym5,
           dil16]
  stage 3: the same sequence without downsampling (128 channels)

NCHW throughout: ``ENetEncoder`` maps (B, 3, H, W) to (B, 128, H/8, W/8),
the 128-channel multiview feature (328 x 256 frames give 41 x 32 maps).
Parameter names follow the Flax tree (``b2_3.conv_a.weight``), so
``convert.state_dict_from_flax`` carries the JAX package's weights.  Every
convolution before a BatchNorm is bias-free, as in the JAX package (the
converter folds the reference's core-conv biases into the BN's running
mean).  BatchNorm has epsilon 1e-3 and momentum 0.1 in torch's convention
(Flax's 0.9), and updates its running variance with the biased batch
variance, as Flax does.  Dropout is element-wise (Flax's ``nn.Dropout``,
not a channel dropout), off in eval; in training it draws from the
``torch.Generator`` the caller passes.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from scan2cap_torch.device import resolve_device
from scan2cap_torch.models.layers import seeded_init

# (dilation, asymmetric kernel) of the bottlenecks after stage 2's first
STAGE = ((1, 0), (2, 0), (1, 5), (4, 0), (1, 0), (8, 0), (1, 5), (16, 0))


class PReLU(nn.Module):
    """x where x >= 0, else alpha * x, one alpha per channel (axis 1)."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.full((features,), 0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.prelu(x, self.weight)


class BatchNorm2d(nn.Module):
    """BatchNorm over (N, H, W) of an NCHW tensor with Flax's statistics:
    epsilon 1e-3, and the running variance updated with the biased batch
    variance."""

    def __init__(self, features: int, eps: float = 1e-3,
                 momentum: float = 0.1):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if not train:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(m * mean)
            self.running_var.mul_(1.0 - m).add_(m * var)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)


def _conv(cin: int, cout: int, kernel, stride=1, padding=0, dilation=1,
          bias: bool = False) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel, stride, padding, dilation, bias=bias)


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Element-wise dropout: each element kept with probability 1 - rate
    and scaled by 1 / (1 - rate); the identity in eval or at rate 0."""
    if not train or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training needs a torch.Generator")
    keep = torch.rand(x.shape, generator=generator, device=x.device,
                      dtype=x.dtype) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class InitialBlock(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = _conv(3, 13, 3, stride=2, padding=1, bias=True)
        self.bn = BatchNorm2d(16)
        self.prelu = PReLU(16)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        out = torch.cat([self.conv(x), F.max_pool2d(x, 2, 2)], dim=1)
        return self.prelu(self.bn(out, train))


class Bottleneck(nn.Module):
    """1x1 (2x2/2 when downsampling) -> core conv -> 1x1, added to the
    shortcut (2x2 max-pooled when downsampling, zero-padded by channel)."""

    def __init__(self, in_ch: int, out_ch: int, internal: int,
                 downsample: bool = False, dilation: int = 1,
                 asymmetric: int = 0, dropout_rate: float = 0.1):
        super().__init__()
        self.downsample, self.asymmetric = downsample, asymmetric
        self.pad = out_ch - in_ch
        self.dropout_rate = dropout_rate
        self.proj = (_conv(in_ch, internal, 2, stride=2) if downsample
                     else _conv(in_ch, internal, 1))
        self.bn1, self.prelu1 = BatchNorm2d(internal), PReLU(internal)
        if asymmetric:
            # 1xk before kx1, the reference's order (enet.py:310-312): zero
            # padding makes the composition order-sensitive at the borders
            k = asymmetric
            self.conv_a = _conv(internal, internal, (1, k), padding=(0, k // 2))
            self.conv_b = _conv(internal, internal, (k, 1), padding=(k // 2, 0))
        else:
            self.conv = _conv(internal, internal, 3, padding=dilation,
                              dilation=dilation)
        self.bn2, self.prelu2 = BatchNorm2d(internal), PReLU(internal)
        self.expand = _conv(internal, out_ch, 1)
        self.bn3 = BatchNorm2d(out_ch)
        self.prelu_out = PReLU(out_ch)

    def forward(self, x: torch.Tensor, train: bool,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = self.prelu1(self.bn1(self.proj(x), train))
        h = (self.conv_b(self.conv_a(h)) if self.asymmetric
             else self.conv(h))
        h = self.prelu2(self.bn2(h, train))
        h = self.bn3(self.expand(h), train)
        h = dropout(h, self.dropout_rate, train, generator)
        shortcut = F.max_pool2d(x, 2, 2) if self.downsample else x
        if self.pad:
            shortcut = F.pad(shortcut, (0, 0, 0, 0, 0, self.pad))
        return self.prelu_out(h + shortcut)


def _blocks() -> Tuple[Tuple[str, Bottleneck], ...]:
    blocks = [("b1_0", Bottleneck(16, 64, 16, downsample=True,
                                  dropout_rate=0.01))]
    blocks += [(f"b1_{i + 1}", Bottleneck(64, 64, 16, dropout_rate=0.01))
               for i in range(4)]
    blocks.append(("b2_0", Bottleneck(64, 128, 32, downsample=True)))
    for stage in ("b2", "b3"):
        blocks += [(f"{stage}_{i + 1}",
                    Bottleneck(128, 128, 32, dilation=d, asymmetric=a))
                   for i, (d, a) in enumerate(STAGE)]
    return tuple(blocks)


class ENetEncoder(nn.Module):
    """The feature trunk: (B, 3, H, W) -> (B, 128, H/8, W/8)."""

    def __init__(self, device: str | torch.device = "cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.initial = InitialBlock()
        for name, block in _blocks():
            self.add_module(name, block)
        seeded_init(self, seed)
        self.device = dev
        self.to(dev)
        self.eval()

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.initial(x, train)
        for name, _ in self.named_children():
            if name != "initial":
                x = getattr(self, name)(x, train, generator)
        return x


class ENetClassifier(nn.Module):
    """The encoder and a bias-free 1x1 classification head (the 2D semantic
    logits at 1/8 resolution, as the reference's head, enet.py:588-590)."""

    def __init__(self, num_classes: int = 41,
                 device: str | torch.device = "cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.encoder = ENetEncoder(device="cpu", seed=seed)
        self.classifier = _conv(128, num_classes, 1)
        seeded_init(self.classifier, seed + 1)
        self.device = self.encoder.device = dev
        self.to(dev)
        self.eval()

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        feat = self.encoder(x, train, generator)
        return feat, self.classifier(feat)


def create_enet_for_3d(num_2d_classes: int = 41,
                       device: str | torch.device = "cuda", seed: int = 0):
    """The reference's ``create_enet_for_3d`` (enet.py:697-715): the trunk,
    whose output is the 128-channel multiview feature, and the classifier."""
    return (ENetEncoder(device=device, seed=seed),
            ENetClassifier(num_2d_classes, device=device, seed=seed))
