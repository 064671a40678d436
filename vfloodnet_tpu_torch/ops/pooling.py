"""7x7 stride-1 local pools of the URR decoder, NCHW (counterpart of
``vfloodnet_tpu.ops.pooling``, which is NHWC)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def local_avg_pool(x: torch.Tensor, size: int = 7) -> torch.Tensor:
    """Zero-padded average; the padding counts in the divisor."""
    return F.avg_pool2d(x, size, stride=1, padding=size // 2,
                        count_include_pad=True)


def local_max_pool(x: torch.Tensor, size: int = 7) -> torch.Tensor:
    """Max over the window; the padding never wins."""
    return F.max_pool2d(x, size, stride=1, padding=size // 2)
