"""ResNet-50 feature backbone with frozen BatchNorm, NCHW (counterpart of
``vfloodnet_tpu.models.resnet``).

Stem + layer1 (1/4, 256) + layer2 (1/8, 512) + layer3 (1/16, 1024), and
layer4 (1/32, 2048) with ``with_layer4`` (METRO's torchvision trunk; AFB-URR
never uses it). BatchNorm always runs with its stored statistics.

The JAX memory encoder adds its mask planes to the stem by concatenating
their 7x7 kernels (``StemKernel``) to the frame's along the input channels;
here the weight bridge does that concatenation once, so the stem is one
``in_channels``-plane convolution.

Every module takes the compute ``dtype`` (float32 or bfloat16), as the JAX
modules do: convolutions run in it, and the frozen BatchNorm normalises in
float32 and casts its output back to it.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in ``compute_dtype``: the input, the kernel
    (a no-op once ``cast_floating_params`` cast it) and the float32 bias
    are cast to it at the call, as flax promotes them inside every apply.
    ``F.conv2d`` refuses a bias of another dtype than its input, so the
    stored bias stays float32 and is cast here."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(cd)
        return self._conv_forward(x.to(cd), self.weight.to(cd), bias)


class FrozenBN(nn.Module):
    """``(x - mean) * weight + bias`` per channel in float32, cast to
    ``dtype``; the weight bridge folds the Flax ``scale`` and running
    ``var`` into ``weight = scale / sqrt(var + eps)``."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.register_buffer("weight", torch.ones(channels))
        self.register_buffer("bias", torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ((x.float() - self.mean[:, None, None])
                * self.weight[:, None, None]
                + self.bias[:, None, None]).to(self.dtype)


def _conv(cin: int, cout: int, k: int, stride: int = 1,
          dtype: torch.dtype = torch.float32) -> Conv2d:
    return Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False,
                  dtype=dtype)


class Bottleneck(nn.Module):
    """torchvision-v1.5 bottleneck (stride on the 3x3 conv)."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        cout = 4 * features
        self.conv1 = _conv(cin, features, 1, dtype=dtype)
        self.bn1 = FrozenBN(features, dtype)
        self.conv2 = _conv(features, features, 3, stride, dtype)
        self.bn2 = FrozenBN(features, dtype)
        self.conv3 = _conv(features, cout, 1, dtype=dtype)
        self.bn3 = FrozenBN(cout, dtype)
        self.downsample = cin != cout or stride != 1
        if self.downsample:
            self.downsample_conv = _conv(cin, cout, 1, stride, dtype)
            self.downsample_bn = FrozenBN(cout, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if self.downsample:
            x = self.downsample_bn(self.downsample_conv(x))
        return F.relu(y + x)


def _layer(cin: int, features: int, blocks: int, stride: int,
           dtype: torch.dtype) -> nn.Sequential:
    mods = [Bottleneck(cin, features, stride, dtype)]
    mods += [Bottleneck(4 * features, features, dtype=dtype)
             for _ in range(blocks - 1)]
    return nn.Sequential(*mods)


class ResNet50Backbone(nn.Module):
    """Returns (r4 1/16 1024ch, r3 1/8 512ch, r2 1/4 256ch, r1 1/2 64ch), or
    with ``with_layer4`` (r5 1/32 2048ch, r4, r3, r2)."""

    def __init__(self, in_channels: int = 3,
                 dtype: torch.dtype = torch.float32,
                 with_layer4: bool = False):
        super().__init__()
        self.conv1 = _conv(in_channels, 64, 7, 2, dtype)
        self.bn1 = FrozenBN(64, dtype)
        self.layer1 = _layer(64, 64, 3, 1, dtype)
        self.layer2 = _layer(256, 128, 4, 2, dtype)
        self.layer3 = _layer(512, 256, 6, 2, dtype)
        self.with_layer4 = with_layer4
        if with_layer4:
            self.layer4 = _layer(1024, 512, 3, 2, dtype)

    def forward(self, x: torch.Tensor):
        r1 = F.relu(self.bn1(self.conv1(x)))
        y = F.max_pool2d(r1, 3, stride=2, padding=1)
        r2 = self.layer1(y)
        r3 = self.layer2(r2)
        r4 = self.layer3(r3)
        if self.with_layer4:
            return self.layer4(r4), r4, r3, r2
        return r4, r3, r2, r1
