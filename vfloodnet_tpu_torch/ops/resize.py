"""Resize ops (counterpart of ``vfloodnet_tpu.ops.resize``).

- ``bicubic``: torch's own kernel (Keys a=-0.75, half-pixel centres,
  replicated edges, no antialias), which is the kernel the JAX package
  rebuilt as dense matrices.
- ``nearest``: JAX's half-pixel nearest, ``src = floor((i + 0.5) * in / out)``
  computed in float32 as ``jax.image.resize`` does. Used by the device
  largest-CC cleanup.
- ``nearest_torch``: floor indexing, ``src = floor(i * (in / out))`` in
  float64, as the JAX package computes it. Used for the first-mask downsize.

Both nearests gather with indices computed in numpy exactly as the JAX
package computes them. ``F.interpolate``'s ``nearest-exact`` and ``nearest``
round differently at some sizes (it multiplies by a float32 scale), so
they are not used.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def short_side_size(h: int, w: int, target: int) -> Tuple[int, int]:
    """(new_h, new_w) with the short side at ``target`` and the long side
    truncated, as torchvision's single-int Resize computes it."""
    if h <= w:
        return target, max(1, int(target * w / h))
    return max(1, int(target * h / w)), target


def _nearest_index(n_in: int, n_out: int, method: str) -> np.ndarray:
    if method == "nearest":
        src = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) \
            * np.float32(n_in) / np.float32(n_out)
        return np.minimum(np.floor(src).astype(np.int64), n_in - 1)
    return np.floor(np.arange(n_out) * (n_in / n_out)).astype(np.int64)


def resize(x: torch.Tensor, out_hw: Tuple[int, int], method: str = "bicubic",
           spatial_axes: Tuple[int, int] = (-3, -2)) -> torch.Tensor:
    """Resize the two spatial axes of ``x`` (default NHWC) to ``out_hw``.
    ``method`` in {bicubic, nearest, nearest_torch}."""
    h_ax = spatial_axes[0] % x.ndim
    w_ax = spatial_axes[1] % x.ndim
    if method in ("nearest", "nearest_torch"):
        for ax, n_out in ((h_ax, out_hw[0]), (w_ax, out_hw[1])):
            if x.shape[ax] != n_out:
                idx = _nearest_index(x.shape[ax], n_out, method)
                x = x.index_select(ax, torch.from_numpy(idx).to(x.device))
        return x
    if method != "bicubic":
        raise ValueError(f"unknown resize method {method!r}")
    if tuple(x.shape[a] for a in (h_ax, w_ax)) == tuple(out_hw):
        return x
    # move the spatial axes last, fold the rest into the channel axis
    y = x.movedim((h_ax, w_ax), (-2, -1))
    lead = y.shape[:-2]
    y = y.reshape((1, -1) + y.shape[-2:])
    y = F.interpolate(y, size=tuple(out_hw), mode="bicubic",
                      align_corners=False)
    y = y.reshape(lead + tuple(out_hw))
    return y.movedim((-2, -1), (h_ax, w_ax))
