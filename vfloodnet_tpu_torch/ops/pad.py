"""Padding to multiples of ``d`` (counterpart of ``vfloodnet_tpu.ops.pad``)."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


def pad_amounts(h: int, w: int, d: int) -> Tuple[int, int, int, int]:
    """(top, bottom, left, right) padding that makes (h, w) multiples of
    ``d``, split as the reference does (floor on the leading side)."""
    new_h = h + (d - h % d) % d
    new_w = w + (d - w % d) % d
    top = (new_h - h) // 2
    left = (new_w - w) // 2
    return top, new_h - h - top, left, new_w - w - left


def pad_divide_by(x: torch.Tensor, d: int,
                  spatial_axes: Tuple[int, int] = (-3, -2)):
    """Zero-pad the spatial axes of ``x`` (default NHWC) to multiples of
    ``d``. Returns (padded, (top, bottom, left, right))."""
    h_ax = spatial_axes[0] % x.ndim
    w_ax = spatial_axes[1] % x.ndim
    pad = pad_amounts(x.shape[h_ax], x.shape[w_ax], d)
    widths = [0] * (2 * x.ndim)          # F.pad order: last axis first
    widths[2 * (x.ndim - 1 - h_ax):2 * (x.ndim - 1 - h_ax) + 2] = pad[:2]
    widths[2 * (x.ndim - 1 - w_ax):2 * (x.ndim - 1 - w_ax) + 2] = pad[2:]
    if not any(widths):
        return x, pad
    return F.pad(x, widths), pad


def unpad(x: torch.Tensor, pad: Sequence[int],
          spatial_axes: Tuple[int, int] = (-3, -2)) -> torch.Tensor:
    """Inverse of :func:`pad_divide_by`."""
    top, bottom, left, right = pad
    h_ax = spatial_axes[0] % x.ndim
    w_ax = spatial_axes[1] % x.ndim
    idx = [slice(None)] * x.ndim
    idx[h_ax] = slice(top, x.shape[h_ax] - bottom)
    idx[w_ax] = slice(left, x.shape[w_ax] - right)
    return x[tuple(idx)]
