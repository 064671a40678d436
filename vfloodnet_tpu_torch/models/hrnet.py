"""HRNet classification-style backbone with frozen BatchNorm, NCHW
(counterpart of ``vfloodnet_tpu.models.hrnet``): the ``featmaps`` variant
METRO's HRNet-W64 trunk uses.

- a stride-4 stem (conv1/bn1/conv2/bn2), ``layer1``: 4 Bottlenecks
  (64 -> 256);
- transitions (transition 1 re-convolves both branches, later ones add
  the new downsampled branch only);
- stages of HighResolutionModules (W64: 1/4/3 modules in stages 2/3/4),
  each 4 BasicBlocks a branch and the full fuse layers: strided 3x3
  convolutions down, a 1x1 convolution and a nearest upsample up, ReLU
  after the sum;
- the featmaps head: a Bottleneck a branch, biased strided 3x3
  convolutions down the branches, a biased 1x1 to the 2048-channel grid
  at /32.

Module names are the JAX package's Flax paths with ``.`` for ``/``, so
:func:`vfloodnet_tpu_torch.core.convert.convert_metro_variables` maps
weights one to one. The fuse layers' upsample is ``jax.image.resize``'s
``nearest`` (half-pixel: ``ops/resize.py``'s ``nearest``), not
``F.interpolate``'s floor; the two differ once a side is not a multiple
of 32.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.resize import resize
from .resnet import Bottleneck, Conv2d, FrozenBN


def _conv_bn(module: nn.Module, name: str, cin: int, cout: int, k: int,
             stride: int = 1, bias: bool = False, bn: str = None) -> None:
    module.add_module(f"{name}conv" if bn is None else name,
                      Conv2d(cin, cout, k, stride=stride, padding=k // 2,
                             bias=bias))
    module.add_module(f"{name}bn" if bn is None else bn, FrozenBN(cout))


class BasicBlock(nn.Module):
    """A stage's BasicBlock (channels match inside a branch: no
    downsample path)."""

    def __init__(self, features: int):
        super().__init__()
        _conv_bn(self, "conv1", features, features, 3, bn="bn1")
        _conv_bn(self, "conv2", features, features, 3, bn="bn2")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(y)) + x)


class HRModule(nn.Module):
    """One HighResolutionModule: per-branch block stacks, then the fuse
    layers (``fuse{i}_{j}_*``)."""

    def __init__(self, channels: Sequence[int], blocks: int = 4):
        super().__init__()
        self.channels = tuple(channels)
        self.blocks = blocks
        n = len(channels)
        for b, c in enumerate(channels):
            for k in range(blocks):
                self.add_module(f"branch{b}_block{k}", BasicBlock(c))
        for i in range(n):
            for j in range(n):
                if j > i:
                    _conv_bn(self, f"fuse{i}_{j}_", channels[j],
                             channels[i], 1)
                for s in range(i - j):
                    cout = channels[i] if s == i - j - 1 else channels[j]
                    _conv_bn(self, f"fuse{i}_{j}_conv{s}", channels[j], cout,
                             3, 2, bn=f"fuse{i}_{j}_bn{s}")

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        ys = []
        for b, x in enumerate(xs):
            for k in range(self.blocks):
                x = getattr(self, f"branch{b}_block{k}")(x)
            ys.append(x)
        outs = []
        n = len(ys)
        for i in range(n):
            acc = ys[i]
            for j in range(n):
                if j > i:
                    y = getattr(self, f"fuse{i}_{j}_bn")(
                        getattr(self, f"fuse{i}_{j}_conv")(ys[j]))
                    y = resize(y, tuple(ys[i].shape[-2:]), method="nearest",
                               spatial_axes=(-2, -1))
                elif j < i:
                    y = ys[j]
                    for s in range(i - j):
                        y = getattr(self, f"fuse{i}_{j}_bn{s}")(
                            getattr(self, f"fuse{i}_{j}_conv{s}")(y))
                        if s < i - j - 1:
                            y = F.relu(y)
                else:
                    continue
                acc = acc + y
            outs.append(F.relu(acc))
        return outs


HEAD_PLANES = (32, 64, 128, 256)


class HRNet(nn.Module):
    """HRNet returning (the 2048-channel grid feature at /32, the highest
    resolution branch at /4), both NCHW."""

    def __init__(self, width: int = 64,
                 modules: Tuple[int, int, int] = (1, 4, 3)):
        super().__init__()
        w = width
        chans = (w, 2 * w, 4 * w, 8 * w)
        self.modules_per_stage = tuple(modules)
        _conv_bn(self, "conv1", 3, 64, 3, 2, bn="bn1")
        _conv_bn(self, "conv2", 64, 64, 3, 2, bn="bn2")
        for k in range(4):
            self.add_module(f"layer1_{k}", Bottleneck(64 if k == 0 else 256,
                                                      64))
        _conv_bn(self, "transition1_0_", 256, chans[0], 3, 1)
        _conv_bn(self, "transition1_1_", 256, chans[1], 3, 2)
        for s, n_mod in zip((2, 3, 4), modules):
            if s > 2:
                _conv_bn(self, f"transition{s - 1}_{s - 1}_",
                         chans[s - 2], chans[s - 1], 3, 2)
            for m in range(n_mod):
                self.add_module(f"stage{s}_{m}", HRModule(chans[:s]))
        for i in range(4):
            self.add_module(f"incre{i}", Bottleneck(chans[i], HEAD_PLANES[i]))
        for i in range(3):
            _conv_bn(self, f"downsamp{i}_", 4 * HEAD_PLANES[i],
                     4 * HEAD_PLANES[i + 1], 3, 2, bias=True)
        _conv_bn(self, "final_", 4 * HEAD_PLANES[3], 2048, 1, bias=True)

    def _trans(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return F.relu(getattr(self, f"{name}bn")(getattr(self,
                                                         f"{name}conv")(x)))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))                  # /4
        for k in range(4):
            h = getattr(self, f"layer1_{k}")(h)
        xs = [self._trans(h, "transition1_0_"),
              self._trans(h, "transition1_1_")]
        for s, n_mod in zip((2, 3, 4), self.modules_per_stage):
            if s > 2:
                xs = xs + [self._trans(xs[-1], f"transition{s - 1}_{s - 1}_")]
            for m in range(n_mod):
                xs = getattr(self, f"stage{s}_{m}")(xs)
        ys = [getattr(self, f"incre{i}")(xs[i]) for i in range(4)]
        agg = ys[0]
        for i in range(3):
            y = getattr(self, f"downsamp{i}_bn")(
                getattr(self, f"downsamp{i}_conv")(agg))
            agg = ys[i + 1] + F.relu(y)
        out = self.final_bn(self.final_conv(agg))
        return F.relu(out), xs[0]
