"""ResNet-18-d1 feature encoder (fgvc_tpu/models/resnet.py), NCHW.

The shipped FGVC recipes use ResNet(depth=18, strides=(1, 1, 1, 4),
out_indices=(2,), pool_type='none'): a 7x7/2 stem with no max-pool, so layer3
features are at stride 2.  layer4 keeps its parameters, so checkpoints load
unchanged, but never runs.  Module names follow torchvision (conv1, bn1,
layerX.Y.convN / bnN / downsample.0-1); models/weights.py maps the other
namings onto them.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn


class BasicBlock(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes, eps=1e-5)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes, eps=1e-5)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, planes, 1, stride, bias=False),
                nn.BatchNorm2d(planes, eps=1e-5),
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + identity)


class ResNet(nn.Module):
    """Basic-block ResNet returning the output of stage `out_index`."""

    def __init__(
        self,
        stage_blocks: Sequence[int] = (2, 2, 2, 2),
        strides: Sequence[int] = (1, 2, 2, 2),
        out_index: int = 3,
        in_channels: int = 3,
    ):
        super().__init__()
        self.out_index = out_index
        self.conv1 = nn.Conv2d(in_channels, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64, eps=1e-5)
        inplanes = 64
        for i, n in enumerate(stage_blocks):
            planes = 64 * 2**i
            blocks = []
            for j in range(n):
                blocks.append(BasicBlock(inplanes, planes, strides[i] if j == 0 else 1))
                inplanes = planes
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.bn1(self.conv1(x)))
        for i in range(self.out_index + 1):
            x = getattr(self, f"layer{i + 1}")(x)
        return x


def resnet18_d1() -> ResNet:
    """The encoder of every shipped FGVC recipe: stride-2 layer3 features."""
    return ResNet((2, 2, 2, 2), strides=(1, 1, 1, 4), out_index=2)


def init_random(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random weights: convolutions ~ N(0, 1 / fan_in), batch norm at
    identity (scale 1, shift 0, running mean 0, variance 1).  The numbers
    differ from flax's initialiser for the same seed."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
                m.weight.copy_(
                    torch.randn(m.weight.shape, generator=g) / math.sqrt(fan_in)
                )
            elif isinstance(m, nn.BatchNorm2d):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
                m.reset_running_stats()
    return model
