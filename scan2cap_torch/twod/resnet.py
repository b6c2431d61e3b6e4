"""The ResNet-v1 bottleneck feature extractor from a torchvision ``.pth``
(counterpart of ``scan2cap_tpu/twod/resnet.py``).

The reference's 2D pipeline takes 2048-d features from torchvision's
``resnet101`` less its fc layer (Scan2Cap-2D/preprocessing/model.py:6-57).
``convert_resnet_checkpoint`` maps a torchvision-layout state dict
(``conv1/bn1/layer{1..4}.{i}.conv{1..3}|bn{1..3}|downsample``) onto the
same nested tree as the JAX package: each convolution's kernel in HWIO
with its eval BatchNorm folded into a per-channel scale and shift, and
each block's stride (torchvision's Bottleneck strides on conv2).  Block
counts come from the keys, so one converter serves resnet50/101/152 and
the tiny replicas the tests build.

``ResNet`` is the eval-mode forward in NCHW: cuDNN convolutions (TF32 off,
``scan2cap_torch/__init__.py``), ``y * scale + shift``, the stem's 3x3/2
max-pool padded with -inf, and the global average pool (the
``children()[:-1]`` truncation keeps the pool and drops fc).
``convert.resnet_state_dict`` carries the tree into its state dict.
``make_pth_extractor`` runs it on the card unless asked for the CPU.
"""

from __future__ import annotations

import re
from typing import Dict, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

_BN_EPS = 1e-5  # torchvision BatchNorm2d default
MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)


def _bn_scale_shift(sd: Dict[str, np.ndarray], prefix: str):
    gamma = sd[prefix + ".weight"].astype(np.float64)
    beta = sd[prefix + ".bias"].astype(np.float64)
    mean = sd[prefix + ".running_mean"].astype(np.float64)
    var = sd[prefix + ".running_var"].astype(np.float64)
    scale = gamma / np.sqrt(var + _BN_EPS)
    shift = beta - mean * scale
    return scale.astype(np.float32), shift.astype(np.float32)


def _conv_bn(sd: Dict[str, np.ndarray], conv_prefix: str, bn_prefix: str):
    w = sd[conv_prefix + ".weight"]                     # (O, I, kH, kW)
    scale, shift = _bn_scale_shift(sd, bn_prefix)
    return {
        "kernel": np.transpose(w, (2, 3, 1, 0)).astype(np.float32),  # HWIO
        "scale": scale,
        "shift": shift,
    }


def convert_resnet_checkpoint(
        src: Union[str, Dict[str, np.ndarray]]) -> dict:
    """torchvision ResNet state dict (a ``.pth`` path or a dict of arrays or
    tensors) -> the params tree::

        {"stem": {kernel, scale, shift},
         "layer1": [block, ...], ..., "layer4": [block, ...]}

    where block = {"conv1"|"conv2"|"conv3": {kernel, scale, shift},
    optionally "downsample": {kernel, scale, shift}, "stride": int}."""
    from scan2cap_torch.convert import load_reference
    sd = load_reference(src)

    params = {"stem": _conv_bn(sd, "conv1", "bn1")}
    for layer in (1, 2, 3, 4):
        blocks = sorted({
            int(m.group(1))
            for k in sd
            for m in [re.match(rf"layer{layer}\.(\d+)\.", k)] if m})
        assert blocks == list(range(len(blocks))), (layer, blocks)
        out = []
        for i in blocks:
            base = f"layer{layer}.{i}"
            block = {
                "conv1": _conv_bn(sd, base + ".conv1", base + ".bn1"),
                "conv2": _conv_bn(sd, base + ".conv2", base + ".bn2"),
                "conv3": _conv_bn(sd, base + ".conv3", base + ".bn3"),
                # torchvision Bottleneck carries the stride on conv2;
                # layer1 keeps stride 1, layers 2-4 downsample in block 0
                "stride": 2 if (layer > 1 and i == 0) else 1,
            }
            if base + ".downsample.0.weight" in sd:
                block["downsample"] = _conv_bn(
                    sd, base + ".downsample.0", base + ".downsample.1")
            out.append(block)
        params[f"layer{layer}"] = out
    return params


class ConvScale(nn.Module):
    """A bias-free convolution and its folded BatchNorm:
    ``conv(x) * scale + shift`` per output channel."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: int = 0):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.zeros(cout, cin, kernel, kernel))
        self.scale = nn.Parameter(torch.ones(cout))
        self.shift = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x, self.weight, stride=self.stride,
                     padding=self.padding)
        return y * self.scale[:, None, None] + self.shift[:, None, None]


class Bottleneck(nn.Module):
    """torchvision's Bottleneck in eval: 1x1, 3x3 (the stride), 1x1 to
    4 x planes, and a 1x1 downsample where the shape changes."""

    def __init__(self, inplanes: int, planes: int, stride: int,
                 downsample: bool):
        super().__init__()
        self.conv1 = ConvScale(inplanes, planes, 1)
        self.conv2 = ConvScale(planes, planes, 3, stride, 1)
        self.conv3 = ConvScale(planes, planes * 4, 1)
        self.downsample = (ConvScale(inplanes, planes * 4, 1, stride)
                           if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.conv1(x))
        y = torch.relu(self.conv2(y))
        y = self.conv3(y)
        if self.downsample is not None:
            x = self.downsample(x)
        return torch.relu(x + y)


class ResNet(nn.Module):
    """The eval-mode bottleneck ResNet in torchvision's layout: ``blocks``
    per layer ((3, 4, 23, 3) for resnet101), the stem ``width`` wide (64);
    (B, 3, H, W) normalized images -> (B, 32 * width) pooled features."""

    def __init__(self, blocks: Sequence[int] = (3, 4, 23, 3),
                 width: int = 64):
        super().__init__()
        self.stem = ConvScale(3, width, 7, 2, 3)
        inplanes = width
        for layer, n in enumerate(blocks, start=1):
            planes = width * 2 ** (layer - 1)
            stride = 1 if layer == 1 else 2
            mods = []
            for i in range(n):
                s = stride if i == 0 else 1
                mods.append(Bottleneck(inplanes, planes, s,
                                       s != 1 or inplanes != planes * 4))
                inplanes = planes * 4
            setattr(self, f"layer{layer}", nn.ModuleList(mods))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.stem(x))
        # MaxPool2d(3, stride=2, padding=1) pads with -inf
        x = F.max_pool2d(x, 3, 2, 1)
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            for block in layer:
                x = block(x)
        return x.mean(dim=(2, 3))


def resnet_from_params(params: dict, device="cuda") -> ResNet:
    """``convert_resnet_checkpoint``'s tree as a ``ResNet`` on ``device``
    in eval mode (block counts and width from the tree)."""
    from scan2cap_torch.convert import resnet_state_dict
    from scan2cap_torch.device import resolve_device

    blocks = tuple(len(params[f"layer{i}"]) for i in (1, 2, 3, 4))
    width = params["stem"]["kernel"].shape[-1]
    model = ResNet(blocks, width)
    for i in (1, 2, 3, 4):
        for block, p in zip(getattr(model, f"layer{i}"), params[f"layer{i}"]):
            if block.conv2.stride != p["stride"]:
                raise ValueError(f"layer{i}: stride {p['stride']} is not "
                                 f"torchvision's layout")
    model.load_state_dict(resnet_state_dict(params), strict=True)
    return model.to(resolve_device(device)).eval()


def make_pth_extractor(pth_path: str, device="cuda"):
    """fn(images (B, H, W, 3) float in [0, 1]) -> (B, 2048) numpy float32,
    from a torchvision resnet ``.pth``, on ``device``; carries
    ``.backend = "resnet:pth"``, ``.params`` (the tree) and ``.model``."""
    params = convert_resnet_checkpoint(pth_path)
    model = resnet_from_params(params, device)
    dev = next(model.parameters()).device

    def extract(images: np.ndarray) -> np.ndarray:
        x = (np.asarray(images, np.float32) - MEAN) / STD
        x = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
        with torch.no_grad():
            return model(x.to(dev)).cpu().numpy()

    extract.backend = "resnet:pth"
    extract.params = params
    extract.model = model
    return extract


def random_torchvision_state_dict(blocks: Sequence[int] = (3, 4, 23, 3),
                                  width: int = 64, seed: int = 0,
                                  num_classes: int = 1000
                                  ) -> Dict[str, torch.Tensor]:
    """A seeded random ResNet state dict in torchvision's layout (its keys,
    shapes and dtypes, ``num_batches_tracked`` and the fc layer too): where
    no released checkpoint is at hand, the stand-in that
    ``torch.save`` writes as a ``.pth`` for ``--resnet_pth``.  Convolutions
    N(0, 2 / fan_out) as torchvision initialises them; each BatchNorm's
    scale in [0.5, 1.5), shift N(0, 0.1), running mean N(0, 0.1) and
    running variance in [0.5, 1.5), except the last of each residual
    branch (``bn3``), whose scale lies in [0, 0.1): with running statistics
    that no data set, 33 residual blocks at full scale grow the pooled
    features to 1e7, where a trained network's are of order 1."""
    g = torch.Generator().manual_seed(seed)
    sd: Dict[str, torch.Tensor] = {}

    def conv(key: str, cout: int, cin: int, k: int) -> None:
        std = (2.0 / (cout * k * k)) ** 0.5
        sd[key + ".weight"] = torch.randn(cout, cin, k, k, generator=g) * std

    def bn(key: str, c: int, scale: float = 1.0, low: float = 0.5) -> None:
        sd[key + ".weight"] = low + scale * torch.rand(c, generator=g)
        sd[key + ".bias"] = torch.randn(c, generator=g) * 0.1
        sd[key + ".running_mean"] = torch.randn(c, generator=g) * 0.1
        sd[key + ".running_var"] = 0.5 + torch.rand(c, generator=g)
        sd[key + ".num_batches_tracked"] = torch.tensor(0)

    conv("conv1", width, 3, 7)
    bn("bn1", width)
    inplanes = width
    for layer, n in enumerate(blocks, start=1):
        planes = width * 2 ** (layer - 1)
        for i in range(n):
            base = f"layer{layer}.{i}"
            stride = 2 if (layer > 1 and i == 0) else 1
            conv(base + ".conv1", planes, inplanes, 1)
            bn(base + ".bn1", planes)
            conv(base + ".conv2", planes, planes, 3)
            bn(base + ".bn2", planes)
            conv(base + ".conv3", planes * 4, planes, 1)
            bn(base + ".bn3", planes * 4, scale=0.1, low=0.0)
            if stride != 1 or inplanes != planes * 4:
                conv(base + ".downsample.0", planes * 4, inplanes, 1)
                bn(base + ".downsample.1", planes * 4)
            inplanes = planes * 4
    sd["fc.weight"] = torch.randn(num_classes, inplanes, generator=g) * 0.01
    sd["fc.bias"] = torch.zeros(num_classes)
    return sd
