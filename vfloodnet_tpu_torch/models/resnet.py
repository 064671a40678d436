"""ResNet-50 feature backbone with frozen BatchNorm, NCHW (counterpart of
``vfloodnet_tpu.models.resnet``).

Stem + layer1 (1/4, 256) + layer2 (1/8, 512) + layer3 (1/16, 1024); AFB-URR
never uses layer4. BatchNorm always runs with its stored statistics.

The JAX memory encoder adds its mask planes to the stem by concatenating
their 7x7 kernels (``StemKernel``) to the frame's along the input channels;
here the weight bridge does that concatenation once, so the stem is one
``in_channels``-plane convolution.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class FrozenBN(nn.Module):
    """``(x - mean) * weight + bias`` per channel, where the weight bridge
    folds the Flax ``scale`` and running ``var`` into ``weight = scale /
    sqrt(var + eps)``."""

    def __init__(self, channels: int):
        super().__init__()
        self.register_buffer("weight", torch.ones(channels))
        self.register_buffer("bias", torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ((x - self.mean[:, None, None]) * self.weight[:, None, None]
                + self.bias[:, None, None])


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)


class Bottleneck(nn.Module):
    """torchvision-v1.5 bottleneck (stride on the 3x3 conv)."""

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        cout = 4 * features
        self.conv1 = _conv(cin, features, 1)
        self.bn1 = FrozenBN(features)
        self.conv2 = _conv(features, features, 3, stride)
        self.bn2 = FrozenBN(features)
        self.conv3 = _conv(features, cout, 1)
        self.bn3 = FrozenBN(cout)
        self.downsample = cin != cout or stride != 1
        if self.downsample:
            self.downsample_conv = _conv(cin, cout, 1, stride)
            self.downsample_bn = FrozenBN(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if self.downsample:
            x = self.downsample_bn(self.downsample_conv(x))
        return F.relu(y + x)


def _layer(cin: int, features: int, blocks: int, stride: int) -> nn.Sequential:
    mods = [Bottleneck(cin, features, stride)]
    mods += [Bottleneck(4 * features, features) for _ in range(blocks - 1)]
    return nn.Sequential(*mods)


class ResNet50Backbone(nn.Module):
    """Returns (r4 1/16 1024ch, r3 1/8 512ch, r2 1/4 256ch, r1 1/2 64ch)."""

    def __init__(self, in_channels: int = 3):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, 64, 7, stride=2, padding=3,
                               bias=False)
        self.bn1 = FrozenBN(64)
        self.layer1 = _layer(64, 64, 3, 1)
        self.layer2 = _layer(256, 128, 4, 2)
        self.layer3 = _layer(512, 256, 6, 2)

    def forward(self, x: torch.Tensor):
        r1 = F.relu(self.bn1(self.conv1(x)))
        y = F.max_pool2d(r1, 3, stride=2, padding=1)
        r2 = self.layer1(y)
        r3 = self.layer2(r2)
        r4 = self.layer3(r3)
        return r4, r3, r2, r1
