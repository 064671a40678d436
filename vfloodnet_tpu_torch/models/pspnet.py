"""PSPNet semantic segmentation, NCHW (counterpart of
``vfloodnet_tpu.models.pspnet``): the Atlantis evaluation's model
(``pipelines/atlantis.py``).

A dilated ResNet-50 trunk (the stem at stride 2, a max pool, layer 2 at
stride 2, layers 3 and 4 at stride 1 with dilation 2 and 4 from their
first block on, as the JAX specs give them, not torchvision's
``replace_stride_with_dilation``), the Pyramid Pooling Module and a
classifier, with an auxiliary classifier on layer 3: the forward returns
``(aux_logits, logits)`` at 1/8 of the input, in the compute ``dtype``.

Module names are the Flax ones (``stem``, ``layer3_block0.conv2``,
``ppm.conv1``, ``cls``), so the weight bridge maps paths one to one
(:func:`..core.convert.convert_pspnet_variables`). Flax's integer
padding is symmetric; every block whose input width differs from
``4 * features`` has a ``down_conv``, layer 1's first block too.

The PPM pools with ``jax.image.resize``'s ``linear`` under its default
``antialias=True`` (a triangle kernel widened by the downscale factor,
weights renormalised), not with an average pool, and upsamples back with
the same resize: both are ``ops.resize``'s ``bilinear``.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.resize import resize
from .resnet import Conv2d, FrozenBN

NUM_CLASSES = 56     # ATLANTIS
BN_EPS = 1e-5


class DilatedBottleneck(nn.Module):
    """1x1 -> 3x3 (``stride``, ``dilation``, padding ``dilation``) -> 1x1
    to ``4 * features``, each with a frozen BN, and the shortcut (a 1x1
    ``down_conv`` at ``stride`` where the width or the stride changes)."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 dilation: int = 1, dtype: torch.dtype = torch.float32,
                 norm=FrozenBN):
        super().__init__()
        cout = 4 * features
        self.conv1 = Conv2d(cin, features, 1, bias=False, dtype=dtype)
        self.bn1 = norm(features, dtype)
        self.conv2 = Conv2d(features, features, 3, stride=stride,
                            padding=dilation, dilation=dilation, bias=False,
                            dtype=dtype)
        self.bn2 = norm(features, dtype)
        self.conv3 = Conv2d(features, cout, 1, bias=False, dtype=dtype)
        self.bn3 = norm(cout, dtype)
        self.down = cin != cout or stride != 1
        if self.down:
            self.down_conv = Conv2d(cin, cout, 1, stride=stride, bias=False,
                                    dtype=dtype)
            self.down_bn = norm(cout, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if self.down:
            x = self.down_bn(self.down_conv(x))
        return F.relu(y + x)


class PPM(nn.Module):
    """Pyramid Pooling Module: for each bin b, the input resized to b x b,
    a 1x1 conv to ``reduction``, BN, ReLU, resized back; the input and the
    four branches concatenated along the channels."""

    def __init__(self, cin: int, reduction: int = 512,
                 bins: Sequence[int] = (1, 2, 3, 6),
                 dtype: torch.dtype = torch.float32, norm=FrozenBN):
        super().__init__()
        self.bins = tuple(bins)
        for i in range(len(self.bins)):
            self.add_module(f"conv{i}", Conv2d(cin, reduction, 1, bias=False,
                                               dtype=dtype))
            self.add_module(f"bn{i}", norm(reduction, dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hw = tuple(x.shape[-2:])
        outs = [x]
        for i, b in enumerate(self.bins):
            pooled = resize(x, (b, b), "bilinear", spatial_axes=(-2, -1),
                            antialias=True)
            pooled = F.relu(getattr(self, f"bn{i}")(
                getattr(self, f"conv{i}")(pooled)))
            outs.append(resize(pooled, hw, "bilinear", spatial_axes=(-2, -1),
                               antialias=True))
        return torch.cat(outs, dim=1)


# (features, blocks, stride of the first block, dilation) per layer
SPECS = ((64, 3, 1, 1), (128, 4, 2, 1), (256, 6, 1, 2), (512, 3, 1, 4))


class PSPNet(nn.Module):
    """Images [N, 3, H, W], normalised -> ``(aux_logits, logits)``, each
    [N, num_classes, H / 8, W / 8] in ``dtype``. ``norm`` is
    :class:`FrozenBN` (folded) or ``TrainBN`` (the JAX ``FrozenBN``'s
    leaves unfolded, for the converter's round trip)."""

    def __init__(self, num_classes: int = NUM_CLASSES,
                 dtype: torch.dtype = torch.float32, norm=FrozenBN):
        super().__init__()
        self.num_classes = num_classes
        self.dtype = dtype
        self.stem = Conv2d(3, 64, 7, stride=2, padding=3, bias=False,
                           dtype=dtype)
        self.stem_bn = norm(64, dtype)
        self.blocks = []
        cin = 64
        for li, (f, n, stride, dil) in enumerate(SPECS):
            for b in range(n):
                name = f"layer{li + 1}_block{b}"
                self.add_module(name, DilatedBottleneck(
                    cin, f, stride if b == 0 else 1, dil, dtype, norm))
                self.blocks.append(name)
                cin = 4 * f
        self.ppm = PPM(cin, dtype=dtype, norm=norm)
        self.cls_conv = Conv2d(2 * cin, 512, 3, padding=1, bias=False,
                               dtype=dtype)
        self.cls_bn = norm(512, dtype)
        self.cls = Conv2d(512, num_classes, 1, dtype=dtype)
        self.aux_conv = Conv2d(cin // 2, 256, 3, padding=1, bias=False,
                               dtype=dtype)
        self.aux_bn = norm(256, dtype)
        self.aux = Conv2d(256, num_classes, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        h = F.relu(self.stem_bn(self.stem(x)))
        h = F.max_pool2d(h, 3, stride=2, padding=1)
        aux_feat = None
        for name in self.blocks:
            h = getattr(self, name)(h)
            if name == f"layer3_block{SPECS[2][1] - 1}":
                aux_feat = h
        h = self.ppm(h)
        h = F.relu(self.cls_bn(self.cls_conv(h)))
        logits = self.cls(h)
        a = F.relu(self.aux_bn(self.aux_conv(aux_feat)))
        return self.aux(a), logits


@torch.no_grad()
def seeded_init(model: PSPNet, seed: int = 0) -> PSPNet:
    """The JAX model's initialisers, drawn from a ``torch.Generator`` of
    ``seed`` on the CPU whatever the model's device (so a card and a CPU
    copy agree): every conv kernel Flax's ``lecun_normal`` (a normal cut at
    two deviations, variance 1 / fan-in), biases zero, and each BN as
    Flax initialises it (scale 1, bias 0, mean 0, var 1; folded where the
    BN is)."""
    gen = torch.Generator().manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, nn.Conv2d):
            w = mod.weight
            std = math.sqrt(1.0 / w[0].numel()) / 0.87962566103423978
            cpu = torch.empty(w.shape, dtype=torch.float32)
            nn.init.trunc_normal_(cpu, 0.0, std, -2 * std, 2 * std,
                                  generator=gen)
            w.copy_(cpu)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, FrozenBN):
            mod.weight.fill_(float(np.reciprocal(np.sqrt(
                np.float32(1.0) + np.float32(BN_EPS)))))
            mod.bias.zero_()
            mod.mean.zero_()
    return model
