"""The reference's own image model layout, segmentation_models_pytorch's
``Linknet(encoder_name='efficientnet-b4', classes=1,
activation='sigmoid')`` (counterpart of
``vfloodnet_tpu.models.linknet_smp.LinkNetSMP``), inference only: the
model that the reference's pickled ``.pth`` loads into
(``pipelines/loaders.py::load_linknet``).

- The encoder runs with efficientnet-pytorch's arithmetic: the static
  "same" pads baked at B4's nominal 380 px on every stride-2 conv, and
  the stem's output as the /2 level (the BN epsilon, 1e-3, is folded in
  by the weight bridge).
- Decoder blocks are smp's LinknetDecoder: ``1x1 conv (in -> in // 4) ->
  ConvTranspose2d(k 4, s 2, p 1) -> 1x1 conv (-> out)``, each bias-free
  with BN and ReLU, channels 448-160-56-32-48-32, adding the /16, /8,
  /4 and /2 levels.
- The head is a biased 3x3 conv to one class and a sigmoid.

Names follow the JAX module's (``decoder.block{j}.conv1``, ``tconv``,
``head``), so the weight bridge maps them by path. NHWC in [0, 1] in,
the water probability [N, H, W, 1] float32 out; H and W must be
multiples of 32, as the JAX model requires.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .efficientnet import EfficientNetFeatures
from .linknet import IMAGENET_MEAN, IMAGENET_STD
from .resnet import Conv2d, FrozenBN

DECODER_CHANNELS = (448, 160, 56, 32, 48, 32)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` computing in ``compute_dtype``, as
    :class:`.resnet.Conv2d` does."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        return F.conv_transpose2d(x.to(cd), self.weight.to(cd), None,
                                  self.stride, self.padding)


class SMPDecoderBlock(nn.Module):
    def __init__(self, in_f: int, out_f: int, dtype: torch.dtype):
        super().__init__()
        mid = in_f // 4
        self.conv1 = Conv2d(in_f, mid, 1, bias=False, dtype=dtype)
        self.bn1 = FrozenBN(mid, dtype)
        self.tconv = ConvTranspose2d(mid, mid, 4, stride=2, padding=1,
                                     bias=False, dtype=dtype)
        self.bn2 = FrozenBN(mid, dtype)
        self.conv3 = Conv2d(mid, out_f, 1, bias=False, dtype=dtype)
        self.bn3 = FrozenBN(out_f, dtype)

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.tconv(h)))
        return F.relu(self.bn3(self.conv3(h)))


class SMPDecoderHead(nn.Module):
    """LinknetDecoder + SegmentationHead on the (f2, f4, f8, f16, f32)
    pyramid, NCHW; returns the sigmoid [N, 1, H, W] float32."""

    def __init__(self, dtype: torch.dtype):
        super().__init__()
        ch = DECODER_CHANNELS
        for i in range(5):
            self.add_module(f"block{i}", SMPDecoderBlock(ch[i], ch[i + 1],
                                                         dtype))
        self.head = Conv2d(ch[-1], 1, 3, padding=1, dtype=dtype)

    def forward(self, f2, f4, f8, f16, f32):
        skips = (f16, f8, f4, f2)
        d = f32
        for i in range(5):
            d = getattr(self, f"block{i}")(d)
            if i < len(skips):
                d = d + skips[i]
        return torch.sigmoid(self.head(d).float())


class LinkNetSMP(nn.Module):
    """Binary water segmentation with smp's graph: images [N, H, W, 3] in
    [0, 1] -> sigmoid probability [N, H, W, 1] float32."""

    BN_EPS = 1e-3      # efficientnet-pytorch's and smp's BatchNorms

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.encoder = EfficientNetFeatures(dtype=dtype, smp=True)
        self.decoder = SMPDecoderHead(dtype)
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN)[
            None, :, None, None], persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD)[
            None, :, None, None], persistent=False)

    def forward(self, img01: torch.Tensor) -> torch.Tensor:
        if img01.shape[1] % 32 or img01.shape[2] % 32:
            raise ValueError("LinkNetSMP input H/W must be multiples of 32 "
                             f"(got {tuple(img01.shape[1:3])})")
        x = (img01.permute(0, 3, 1, 2).float() - self.mean) / self.std
        prob = self.decoder(*self.encoder.features_nchw(x))
        return prob.permute(0, 2, 3, 1)
