"""EfficientNet-B4 feature encoder (counterpart of
``vfloodnet_tpu.models.efficientnet``), inference only.

The encoder of the still-image water model: MBConv stages with
squeeze-and-excitation and frozen BatchNorm, B0's stage table scaled by
width 1.4 and depth 1.8, and symmetric ``k // 2`` padding (the TPU-first
graph the bundled checkpoint was trained with). :class:`EfficientNetFeatures`
returns the pyramid at reductions /2, /4, /8, /16, /32: 24, 32, 56, 160
and 448 channels for B4, the /2 level being the output of the stride-1
first stage as in the JAX package's default.

Module and parameter names follow the Flax ones (``stem_conv``,
``stage{s}_block{b}``, ``expand_conv``, ``dw_conv``, ``se.reduce``, ...),
so the weight bridge maps them by path. The public forward is NHWC, as in
the JAX package; inside, the convolutions run NCHW.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from .resnet import Conv2d, FrozenBN

# Base (B0) stage spec: (expand, kernel, stride, in_f, out_f, repeats)
B0_STAGES = [
    (1, 3, 1, 32, 16, 1),
    (6, 3, 2, 16, 24, 2),
    (6, 5, 2, 24, 40, 2),
    (6, 3, 2, 40, 80, 3),
    (6, 5, 1, 80, 112, 3),
    (6, 5, 2, 112, 192, 4),
    (6, 3, 1, 192, 320, 1),
]


def round_filters(f: int, width: float, divisor: int = 8) -> int:
    f = f * width
    new = max(divisor, int(f + divisor / 2) // divisor * divisor)
    if new < 0.9 * f:
        new += divisor
    return int(new)


def round_repeats(r: int, depth: float) -> int:
    return int(math.ceil(r * depth))


class SqueezeExcite(nn.Module):
    def __init__(self, channels: int, reduced: int, dtype: torch.dtype):
        super().__init__()
        self.reduce = Conv2d(channels, reduced, 1, dtype=dtype)
        self.expand = Conv2d(reduced, channels, 1, dtype=dtype)

    def forward(self, x):
        s = x.mean(dim=(2, 3), keepdim=True)
        s = self.expand(F.silu(self.reduce(s)))
        return x * torch.sigmoid(s.float()).to(x.dtype)


# efficientnet-pytorch bakes its "same" padding at the model's nominal
# image size (380 for B4) and applies those static (lo, hi) pads to every
# input; the smp encoder's stride-2 convs (the stem and each stage's first
# block) therefore pad so (the JAX package's ``_SMP_B4_S2_PADS``)
SMP_B4_S2_PADS = {"stem": (0, 1), 1: (0, 1), 2: (2, 2), 3: (0, 1),
                  5: (1, 2)}


class MBConv(nn.Module):
    def __init__(self, in_f: int, expand: int, kernel: int, stride: int,
                 out_f: int, se_from: int, dtype: torch.dtype, pad=None):
        super().__init__()
        mid = in_f * expand
        self.expand = expand
        self.pad = pad
        if expand != 1:
            self.expand_conv = Conv2d(in_f, mid, 1, bias=False, dtype=dtype)
            self.expand_bn = FrozenBN(mid, dtype)
        self.dw_conv = Conv2d(mid, mid, kernel, stride=stride,
                              padding=kernel // 2 if pad is None else 0,
                              groups=mid, bias=False, dtype=dtype)
        self.dw_bn = FrozenBN(mid, dtype)
        self.se = SqueezeExcite(mid, max(1, se_from // 4), dtype)
        self.project_conv = Conv2d(mid, out_f, 1, bias=False, dtype=dtype)
        self.project_bn = FrozenBN(out_f, dtype)
        self.residual = stride == 1 and in_f == out_f

    def forward(self, x):
        h = x
        if self.expand != 1:
            h = F.silu(self.expand_bn(self.expand_conv(h)))
        if self.pad is not None:
            h = F.pad(h, self.pad * 2)
        h = F.silu(self.dw_bn(self.dw_conv(h)))
        h = self.project_bn(self.project_conv(self.se(h)))
        return h + x if self.residual else h


class EfficientNetFeatures(nn.Module):
    """The pyramid /2, /4, /8, /16, /32 of an EfficientNet (B4 by
    default). ``smp`` gives smp's encoder (``LinkNetSMP``'s): the stride-2
    convs padded as efficientnet-pytorch pads them (:data:`SMP_B4_S2_PADS`)
    and the /2 level taken from the stem."""

    def __init__(self, width: float = 1.4, depth: float = 1.8,
                 dtype: torch.dtype = torch.float32, smp: bool = False):
        super().__init__()
        self.dtype = dtype
        self.smp = smp
        stem_f = round_filters(32, width)
        self.stem_pad = SMP_B4_S2_PADS["stem"] if smp else None
        self.stem_conv = Conv2d(3, stem_f, 3, stride=2,
                                padding=0 if smp else 1,
                                bias=False, dtype=dtype)
        self.stem_bn = FrozenBN(stem_f, dtype)
        self.blocks = nn.ModuleDict()
        # block name -> whether the pyramid level before it ends (stride 2)
        self.taps = {}
        in_f = stem_f
        for si, (e, k, s, s_in, s_out, r) in enumerate(B0_STAGES):
            out_sf = round_filters(s_out, width)
            in_sf = round_filters(s_in, width)
            for bi in range(round_repeats(r, depth)):
                stride = s if bi == 0 else 1
                name = f"stage{si}_block{bi}"
                pad = SMP_B4_S2_PADS[si] if smp and stride == 2 \
                    else None
                self.blocks[name] = MBConv(
                    in_f, e, k, stride, out_sf,
                    in_sf if bi == 0 else out_sf, dtype, pad)
                self.taps[name] = stride == 2
                in_f = out_sf

    def features_nchw(self, x: torch.Tensor):
        """x [N, 3, H, W] -> the five levels, NCHW."""
        x = x.to(self.dtype)
        if self.stem_pad is not None:
            x = F.pad(x, self.stem_pad * 2)
        h = F.silu(self.stem_bn(self.stem_conv(x)))
        stem, pyramid = h, []
        for name, block in self.blocks.items():
            if self.taps[name]:
                pyramid.append(h)
            h = block(h)
        if self.smp:
            pyramid[0] = stem
        return tuple(pyramid + [h])

    def forward(self, x: torch.Tensor):
        """x [N, H, W, 3] -> the five levels, NHWC."""
        return tuple(f.permute(0, 2, 3, 1)
                     for f in self.features_nchw(x.permute(0, 3, 1, 2)))
