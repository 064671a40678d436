"""Feature Pyramid Network, NCHW (counterpart of
``vfloodnet_tpu.models.detection.fpn``): lateral 1x1 convolutions, the
2x nearest top-down path, 3x3 outputs, and P6 = P5[..., ::2, ::2]."""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn


def up2_nearest(x: torch.Tensor) -> torch.Tensor:
    """``jax.image.resize(..., "nearest")`` of [N, C, H, W] to twice the
    size: at exactly 2x its half-pixel sources are i // 2."""
    n, c, h, w = x.shape
    return x[:, :, :, None, :, None].expand(n, c, h, 2, w, 2).reshape(
        n, c, 2 * h, 2 * w)


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 out_channels: int = 256):
        super().__init__()
        for i, c in enumerate(in_channels):
            self.add_module(f"lateral{i + 2}", nn.Conv2d(c, out_channels, 1))
            self.add_module(f"output{i + 2}",
                            nn.Conv2d(out_channels, out_channels, 3,
                                      padding=1))
        self.n = len(in_channels)

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """(C2, C3, C4, C5) -> [P2, P3, P4, P5, P6]."""
        laterals = [getattr(self, f"lateral{i + 2}")(f)
                    for i, f in enumerate(feats)]
        tds = [laterals[-1]]
        for lat in laterals[-2::-1]:
            tds.append(lat + up2_nearest(tds[-1]))
        tds = tds[::-1]
        outs = [getattr(self, f"output{i + 2}")(t) for i, t in enumerate(tds)]
        return outs + [outs[-1][..., ::2, ::2]]
