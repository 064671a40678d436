"""Detection backbones, NCHW (counterpart of
``vfloodnet_tpu.models.detection.backbone``): ResNet-101 and
ResNeXt-101-32x8d with frozen BatchNorm, the stride on the 1x1
convolution (Detectron2's ``stride_in_1x1``), grouped 3x3 convolutions.
Module names follow the Flax paths, so the weight bridge maps them one to
one. ``norm=TrainBN`` is the training form: the JAX trainer trains the
BNs' scale and bias and never their statistics."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..resnet import FrozenBN


class DetBottleneck(nn.Module):
    def __init__(self, cin: int, width: int, out_f: int, stride: int = 1,
                 groups: int = 1, norm=FrozenBN):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, width, 1, stride=stride, bias=False)
        self.bn1 = norm(width)
        self.conv2 = nn.Conv2d(width, width, 3, padding=1, groups=groups,
                               bias=False)
        self.bn2 = norm(width)
        self.conv3 = nn.Conv2d(width, out_f, 1, bias=False)
        self.bn3 = norm(out_f)
        self.has_shortcut = cin != out_f or stride != 1
        if self.has_shortcut:
            self.shortcut = nn.Conv2d(cin, out_f, 1, stride=stride,
                                      bias=False)
            self.shortcut_bn = norm(out_f)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if self.has_shortcut:
            x = self.shortcut_bn(self.shortcut(x))
        return F.relu(y + x)


class DetectionResNet(nn.Module):
    """Returns (C2, C3, C4, C5) at strides 4, 8, 16, 32."""

    def __init__(self, blocks: Sequence[int] = (3, 4, 23, 3),
                 groups: int = 1, width_per_group: int = 64, norm=FrozenBN):
        super().__init__()
        self.stem_conv = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.stem_bn = norm(64)
        self.stages = []
        cin, out_f = 64, 256
        for stage, n_blocks in enumerate(blocks):
            width = groups * width_per_group * (2 ** stage)
            names = []
            for b in range(n_blocks):
                name = f"res{stage + 2}_block{b}"
                self.add_module(name, DetBottleneck(
                    cin, width, out_f, (1 if stage == 0 else 2) if b == 0
                    else 1, groups, norm))
                names.append(name)
                cin = out_f
            self.stages.append(names)
            out_f *= 2

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        h = F.relu(self.stem_bn(self.stem_conv(x)))
        h = F.max_pool2d(h, 3, stride=2, padding=1)
        outs = []
        for names in self.stages:
            for name in names:
                h = getattr(self, name)(h)
            outs.append(h)
        return tuple(outs)
