"""LinkNet water segmentation model with an EfficientNet-B4 encoder
(counterpart of ``vfloodnet_tpu.models.linknet``'s TPU-first ``LinkNet``),
inference only.

LinkNet's additive skip connections, with decoder blocks that upsample by
bilinear resize and a conv (the JAX package's design, not smp's
transposed convs), and a two-conv head with a sigmoid. The public forward
takes NHWC images in [0, 1] and returns the water probability [N, H, W, 1]
in float32, as the JAX model does.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .efficientnet import EfficientNetFeatures
from .resnet import Conv2d, FrozenBN

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _up2(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear, half-pixel centres, in float32 and cast back: at an
    exact factor of 2 this is ``jax.image.resize``'s linear."""
    return F.interpolate(x.float(), scale_factor=2, mode="bilinear",
                         align_corners=False).to(x.dtype)


class DecoderBlock(nn.Module):
    """1x1 bottleneck conv -> 2x upsample -> 3x3 conv -> 1x1 expand conv,
    each with frozen BN and ReLU."""

    def __init__(self, in_f: int, out_f: int, dtype: torch.dtype):
        super().__init__()
        mid = max(in_f // 4, 8)
        self.conv1 = Conv2d(in_f, mid, 1, bias=False, dtype=dtype)
        self.bn1 = FrozenBN(mid, dtype)
        self.conv2 = Conv2d(mid, mid, 3, padding=1, bias=False, dtype=dtype)
        self.bn2 = FrozenBN(mid, dtype)
        self.conv3 = Conv2d(mid, out_f, 1, bias=False, dtype=dtype)
        self.bn3 = FrozenBN(out_f, dtype)

    def forward(self, x):
        h = _up2(F.relu(self.bn1(self.conv1(x))))
        h = F.relu(self.bn2(self.conv2(h)))
        return F.relu(self.bn3(self.conv3(h)))


class LinkNet(nn.Module):
    """Binary water segmentation: images [N, H, W, 3] in [0, 1] -> sigmoid
    probability [N, H, W, 1] float32."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.encoder = EfficientNetFeatures(dtype=dtype)
        c2, c4, c8, c16, c32 = self._pyramid_channels()
        self.dec4 = DecoderBlock(c32, c16, dtype)
        self.dec3 = DecoderBlock(c16, c8, dtype)
        self.dec2 = DecoderBlock(c8, c4, dtype)
        self.dec1 = DecoderBlock(c4, c2, dtype)
        self.dec0 = DecoderBlock(c2, 16, dtype)
        self.head1 = Conv2d(16, 16, 3, padding=1, dtype=dtype)
        self.head2 = Conv2d(16, 1, 3, padding=1, dtype=dtype)
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN)[
            None, :, None, None], persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD)[
            None, :, None, None], persistent=False)

    def _pyramid_channels(self):
        taps = [n for n, t in self.encoder.taps.items() if t]
        names = list(self.encoder.blocks)
        # the level before each stride-2 block is the previous block's
        # output; the last level is the last block's
        before = [names[names.index(n) - 1] for n in taps]
        return tuple(self.encoder.blocks[n].project_bn.weight.numel()
                     for n in before + [names[-1]])

    def forward(self, img01: torch.Tensor) -> torch.Tensor:
        h, w = img01.shape[1:3]
        x = (img01.permute(0, 3, 1, 2).float() - self.mean) / self.std
        f2, f4, f8, f16, f32 = self.encoder.features_nchw(x)

        def add_skip(d, skip):
            # stride-2 convs round up: crop the upsample to the skip
            return d[..., :skip.shape[2], :skip.shape[3]] + skip

        d = add_skip(self.dec4(f32), f16)
        d = add_skip(self.dec3(d), f8)
        d = add_skip(self.dec2(d), f4)
        d = add_skip(self.dec1(d), f2)
        d = self.dec0(d)[..., :h, :w]
        logits = self.head2(F.relu(self.head1(d)))
        return torch.sigmoid(logits.float()).permute(0, 2, 3, 1)
