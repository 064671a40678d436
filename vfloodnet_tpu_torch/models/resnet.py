"""ResNet-50 feature backbone with frozen BatchNorm, NCHW (counterpart of
``vfloodnet_tpu.models.resnet``).

Stem + layer1 (1/4, 256) + layer2 (1/8, 512) + layer3 (1/16, 1024), and
layer4 (1/32, 2048) with ``with_layer4`` (METRO's torchvision trunk; AFB-URR
never uses it). The serving form's BatchNorm (:class:`FrozenBN`) runs with
its stored statistics folded into one weight; the training form
(``norm=TrainBN``) keeps the JAX ``FrozenBN``'s trainable ``scale`` and
``bias`` and its running ``mean`` and ``var``, and can normalise with the
batch's statistics.

The JAX memory encoder adds its mask planes to the stem by concatenating
their 7x7 kernels (``StemKernel``) to the frame's along the input channels;
here the weight bridge does that concatenation once, so the stem is one
``in_channels``-plane convolution.

Every module takes the compute ``dtype`` (float32 or bfloat16), as the JAX
modules do: convolutions run in it, and the frozen BatchNorm normalises in
float32 and casts its output back to it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
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


def wide(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32, or as it is if it is float64: the casts that the
    JAX model makes to float32 keep a float64 model float64, so the
    training form can be checked in float64."""
    return x if x.dtype == torch.float64 else x.float()


class _AllReduceSum(torch.autograd.Function):
    """The sum over a process group's ranks, differentiable: the gradient
    of each rank's input is the sum of every rank's output gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def _group_moments(x: torch.Tensor, group):
    """Mean and biased variance per channel of x [N, C, H, W] over (N, H,
    W) of every rank's x in ``group`` (equal shapes), two passes as
    ``var(unbiased=False)``, gradients flowing through both sums."""
    count = x.numel() // x.shape[1] * dist.get_world_size(group)
    mean = _AllReduceSum.apply(x.sum(dim=(0, 2, 3)), group) / count
    d = x - mean[:, None, None]
    var = _AllReduceSum.apply((d * d).sum(dim=(0, 2, 3)), group) / count
    return mean, var


class TrainBN(nn.Module):
    """The JAX package's ``FrozenBN`` as it trains: ``scale`` and ``bias``
    are parameters (AdamW trains them even with the BN frozen), ``mean``
    and ``var`` running statistics. Normalises in float32, ``(x - mean) *
    (scale / sqrt(var + eps)) + bias`` with the JAX order of operations,
    and casts to ``dtype``; in eval form it gives the folded
    :class:`FrozenBN`'s output bit for bit.

    With ``live`` set (``update_bn``), it normalises with the batch's
    mean and biased variance over (N, H, W), gradients flowing through
    them, and leaves them (detached) in ``batch_mean`` / ``batch_var``
    for the trainer, which makes the running update ``0.9 * stat + 0.1 *
    batch`` itself (:func:`vfloodnet_tpu_torch.train.train_video.
    video_clip_loss`); the buffers are never changed here.

    With ``group`` set (a process group of more than one rank; the
    data-parallel image trainer), live statistics are those of every
    rank's batch together, as JAX's are over the global batch of a
    data-sharded step.

    ``dtype`` None gives the output the input's dtype (the detector's
    BNs, which have no compute dtype of their own); ``eps`` is the JAX
    ``FrozenBN``'s (1e-3 in efficientnet-pytorch's encoder)."""

    def __init__(self, channels: int, dtype: Optional[torch.dtype] = None,
                 eps: float = 1e-5):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.live = False
        self.group = None
        self.batch_mean = self.batch_var = None
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = wide(x)
        if self.live:
            if self.group is None or dist.get_world_size(self.group) == 1:
                mean = xf.mean(dim=(0, 2, 3))
                var = xf.var(dim=(0, 2, 3), unbiased=False)
            else:
                mean, var = _group_moments(xf, self.group)
            self.batch_mean, self.batch_var = mean.detach(), var.detach()
        else:
            mean, var = self.mean, self.var
        # the square root through float64: torch's float32 one on the CPU
        # is not always correctly rounded, numpy's fold and XLA's are
        root = torch.sqrt((var + self.eps).double()).to(var.dtype)
        inv = self.scale * torch.reciprocal(root)
        return ((xf - mean[:, None, None]) * inv[:, None, None]
                + self.bias[:, None, None]).to(self.dtype or x.dtype)


def _conv(cin: int, cout: int, k: int, stride: int = 1,
          dtype: torch.dtype = torch.float32) -> Conv2d:
    return Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False,
                  dtype=dtype)


class Bottleneck(nn.Module):
    """torchvision-v1.5 bottleneck (stride on the 3x3 conv)."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32, norm=FrozenBN):
        super().__init__()
        cout = 4 * features
        self.conv1 = _conv(cin, features, 1, dtype=dtype)
        self.bn1 = norm(features, dtype)
        self.conv2 = _conv(features, features, 3, stride, dtype)
        self.bn2 = norm(features, dtype)
        self.conv3 = _conv(features, cout, 1, dtype=dtype)
        self.bn3 = norm(cout, dtype)
        self.downsample = cin != cout or stride != 1
        if self.downsample:
            self.downsample_conv = _conv(cin, cout, 1, stride, dtype)
            self.downsample_bn = norm(cout, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if self.downsample:
            x = self.downsample_bn(self.downsample_conv(x))
        return F.relu(y + x)


def _layer(cin: int, features: int, blocks: int, stride: int,
           dtype: torch.dtype, norm=FrozenBN) -> nn.Sequential:
    mods = [Bottleneck(cin, features, stride, dtype, norm)]
    mods += [Bottleneck(4 * features, features, dtype=dtype, norm=norm)
             for _ in range(blocks - 1)]
    return nn.Sequential(*mods)


class ResNet50Backbone(nn.Module):
    """Returns (r4 1/16 1024ch, r3 1/8 512ch, r2 1/4 256ch, r1 1/2 64ch), or
    with ``with_layer4`` (r5 1/32 2048ch, r4, r3, r2). ``norm`` is
    :class:`FrozenBN` (serving) or :class:`TrainBN` (training)."""

    def __init__(self, in_channels: int = 3,
                 dtype: torch.dtype = torch.float32,
                 with_layer4: bool = False, norm=FrozenBN):
        super().__init__()
        self.conv1 = _conv(in_channels, 64, 7, 2, dtype)
        self.bn1 = norm(64, dtype)
        self.layer1 = _layer(64, 64, 3, 1, dtype, norm)
        self.layer2 = _layer(256, 128, 4, 2, dtype, norm)
        self.layer3 = _layer(512, 256, 6, 2, dtype, norm)
        self.with_layer4 = with_layer4
        if with_layer4:
            self.layer4 = _layer(1024, 512, 3, 2, dtype, norm)

    def forward(self, x: torch.Tensor):
        r1 = F.relu(self.bn1(self.conv1(x)))
        y = F.max_pool2d(r1, 3, stride=2, padding=1)
        r2 = self.layer1(y)
        r3 = self.layer2(r2)
        r4 = self.layer3(r3)
        if self.with_layer4:
            return self.layer4(r4), r4, r3, r2
        return r4, r3, r2, r1
