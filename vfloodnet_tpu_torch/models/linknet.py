"""LinkNet water segmentation model with an EfficientNet-B4 encoder
(counterpart of ``vfloodnet_tpu.models.linknet``'s TPU-first ``LinkNet``).

LinkNet's additive skip connections, with decoder blocks that upsample by
bilinear resize and a conv (the JAX package's design, not smp's
transposed convs), and a two-conv head with a sigmoid. The public forward
takes NHWC images in [0, 1] and returns the water probability [N, H, W, 1]
in float32, as the JAX model does.

``norm=TrainBN`` gives the training form (``train/train_image.py``): the
JAX ``FrozenBN``'s scale, bias, mean and var, unfolded; in eval it gives
the serving form's output bit for bit. Its float32 casts keep a float64
model float64 (:func:`.resnet.wide`), and its upsample's backward is a
product with the interpolation matrices (``afb_urr._upsample2``): the
bilinear upsample's own CUDA backward adds with atomics.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .afb_urr import _upsample2
from .efficientnet import EfficientNetFeatures
from .resnet import Conv2d, FrozenBN, wide

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class DecoderBlock(nn.Module):
    """1x1 bottleneck conv -> 2x upsample -> 3x3 conv -> 1x1 expand conv,
    each with frozen BN and ReLU."""

    def __init__(self, in_f: int, out_f: int, dtype: torch.dtype,
                 norm=FrozenBN):
        super().__init__()
        mid = max(in_f // 4, 8)
        self.conv1 = Conv2d(in_f, mid, 1, bias=False, dtype=dtype)
        self.bn1 = norm(mid, dtype)
        self.conv2 = Conv2d(mid, mid, 3, padding=1, bias=False, dtype=dtype)
        self.bn2 = norm(mid, dtype)
        self.conv3 = Conv2d(mid, out_f, 1, bias=False, dtype=dtype)
        self.bn3 = norm(out_f, dtype)

    def forward(self, x):
        h = _upsample2(F.relu(self.bn1(self.conv1(x))))
        h = F.relu(self.bn2(self.conv2(h)))
        return F.relu(self.bn3(self.conv3(h)))


class LinkNet(nn.Module):
    """Binary water segmentation: images [N, H, W, 3] in [0, 1] -> sigmoid
    probability [N, H, W, 1] float32."""

    def __init__(self, dtype: torch.dtype = torch.float32, norm=FrozenBN):
        super().__init__()
        self.dtype = dtype
        self.encoder = EfficientNetFeatures(dtype=dtype, norm=norm)
        c2, c4, c8, c16, c32 = self._pyramid_channels()
        self.dec4 = DecoderBlock(c32, c16, dtype, norm)
        self.dec3 = DecoderBlock(c16, c8, dtype, norm)
        self.dec2 = DecoderBlock(c8, c4, dtype, norm)
        self.dec1 = DecoderBlock(c4, c2, dtype, norm)
        self.dec0 = DecoderBlock(c2, 16, dtype, norm)
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
        return tuple(self.encoder.blocks[n].project_conv.out_channels
                     for n in before + [names[-1]])

    def forward(self, img01: torch.Tensor) -> torch.Tensor:
        h, w = img01.shape[1:3]
        x = (wide(img01.permute(0, 3, 1, 2)) - self.mean) / self.std
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
        return torch.sigmoid(wide(logits)).permute(0, 2, 3, 1)
