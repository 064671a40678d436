"""ROIAlign as torch gathers (counterpart of ``vfloodnet_tpu.ops.roi_align``):
``aligned`` half-pixel boxes, ``sampling_ratio`` x ``sampling_ratio``
sub-samples a bin, averaged; a sample outside [-1, H] x [-1, W] is zero,
and one inside reads its four clamped neighbours. Features are HWC, as in
the JAX package, so a sample gathers C contiguous values.

:func:`multilevel_roi_align` assigns each box its FPN level (FPN paper
eq. 1) and samples it at that level only. The JAX package samples every
box at every level and keeps one; the values are the same, because a box's
samples read only its own level's map, with that level's scale and size.
All shapes are static and nothing is read back to the host.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

Size = Union[int, torch.Tensor]
LN2_F32 = float(torch.log(torch.tensor(2.0, dtype=torch.float32)))


def bilinear_sample(flat: torch.Tensor, base: Union[int, torch.Tensor],
                    h: Size, w: Size, ys: torch.Tensor, xs: torch.Tensor
                    ) -> torch.Tensor:
    """Sample maps stored row-major in ``flat`` [M, C] at float positions
    ``ys``, ``xs`` [R, ...]: row r reads the [h, w] map that starts at row
    ``base`` of ``flat`` (``base``, ``h``, ``w``: ints, or [R] tensors).
    Returns [R, ..., C] (the JAX package's ``_bilinear_sample``)."""
    extra = (1,) * (ys.ndim - 1)

    def per_row(v):
        return v.reshape((-1,) + extra) if torch.is_tensor(v) else v

    base, hh, ww = per_row(base), per_row(h), per_row(w)
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy1 = (ys - y0)[..., None]
    wx1 = (xs - x0)[..., None]
    h_max = hh - 1 if torch.is_tensor(hh) else h - 1
    w_max = ww - 1 if torch.is_tensor(ww) else w - 1

    def gather(yy, xx):
        yy = torch.clamp(yy.long(), min=0)
        xx = torch.clamp(xx.long(), min=0)
        yy = torch.minimum(yy, h_max) if torch.is_tensor(h_max) \
            else yy.clamp(max=h_max)
        xx = torch.minimum(xx, w_max) if torch.is_tensor(w_max) \
            else xx.clamp(max=w_max)
        idx = base + yy * ww + xx
        return flat.index_select(0, idx.reshape(-1)).reshape(
            idx.shape + flat.shape[-1:])

    v00 = gather(y0, x0)
    v01 = gather(y0, x0 + 1)
    v10 = gather(y0 + 1, x0)
    v11 = gather(y0 + 1, x0 + 1)
    out = (v00 * (1 - wy1) * (1 - wx1) + v01 * (1 - wy1) * wx1
           + v10 * wy1 * (1 - wx1) + v11 * wy1 * wx1)
    inside = (ys >= -1.0) & (ys <= hh) & (xs >= -1.0) & (xs <= ww)
    return out * inside[..., None]


def _sample_grid(boxes: torch.Tensor, scale, pooled: int,
                 sampling_ratio: int):
    """Sample centres (ys, xs) [R, n, n] of each box's n x n grid, n =
    pooled x sampling_ratio, in the JAX package's float32 order."""
    b = boxes * scale
    x1, y1, x2, y2 = (b[..., i] - 0.5 for i in range(4))
    bw = torch.clamp(x2 - x1, min=1e-6)
    bh = torch.clamp(y2 - y1, min=1e-6)
    n = pooled * sampling_ratio
    g = torch.arange(n, device=boxes.device, dtype=torch.float32) + 0.5
    ys = y1[:, None] + g[None, :] * bh[:, None] / n
    xs = x1[:, None] + g[None, :] * bw[:, None] / n
    r = boxes.shape[0]
    return (ys[:, :, None].expand(r, n, n), xs[:, None, :].expand(r, n, n))


def _pool(samples: torch.Tensor, pooled: int, s: int) -> torch.Tensor:
    r, c = samples.shape[0], samples.shape[-1]
    return samples.reshape(r, pooled, s, pooled, s, c).mean(dim=(2, 4))


def roi_align(feat: torch.Tensor, boxes: torch.Tensor, pooled: int = 7,
              spatial_scale: float = 1.0, sampling_ratio: int = 2
              ) -> torch.Tensor:
    """feat [H, W, C]; boxes [R, 4] xyxy in image coordinates ->
    [R, pooled, pooled, C]."""
    h, w, c = feat.shape
    ys, xs = _sample_grid(boxes, spatial_scale, pooled, sampling_ratio)
    samples = bilinear_sample(feat.reshape(h * w, c), 0, h, w, ys, xs)
    return _pool(samples, pooled, sampling_ratio)


def fpn_levels(boxes: torch.Tensor, n_levels: int,
               canonical_size: float = 224.0,
               canonical_level: int = 2) -> torch.Tensor:
    """Each box's level index (0 = the finest map), FPN paper eq. 1, in
    the JAX package's float32 arithmetic (log2 as log(x) / log(2))."""
    ws = torch.clamp(boxes[:, 2] - boxes[:, 0], min=0)
    hs = torch.clamp(boxes[:, 3] - boxes[:, 1], min=0)
    scale = torch.sqrt(ws * hs)
    # float32(log(2)), as lax.log(2.0) gives it
    lg = torch.log(torch.clamp(scale, min=1e-6) / canonical_size) / LN2_F32
    lvl = torch.floor(canonical_level + lg + 1e-6)
    return torch.clamp(lvl, 0, n_levels - 1).long()


def _device_values(values: Sequence[float], dtype, device) -> torch.Tensor:
    """A small tensor of Python numbers made on ``device`` by fills: no
    host-to-device copy, so no host sync."""
    return torch.stack([torch.full((), v, dtype=dtype, device=device)
                        for v in values])


class LevelTable:
    """The FPN maps of one image as one [sum of H_l W_l, C] tensor
    (``maps``: each level's [H, W, C] view of it), with each level's first
    row, height, width and scale as small tensors on the device."""

    def __init__(self, feats: Sequence[torch.Tensor],
                 strides: Sequence[int]):
        dev = feats[0].device
        c = feats[0].shape[-1]
        self.flat = torch.cat([f.reshape(-1, c) for f in feats])
        sizes = [(f.shape[0], f.shape[1]) for f in feats]
        starts = [0]
        for h, w in sizes[:-1]:
            starts.append(starts[-1] + h * w)
        self.n_levels = len(feats)
        # the [H, W, C] maps again, as views of the one tensor
        self.maps = [self.flat[s0:s0 + h * w].reshape(h, w, c)
                     for (h, w), s0 in zip(sizes, starts)]
        self.starts = _device_values(starts, torch.int64, dev)
        self.h = _device_values([h for h, _ in sizes], torch.int64, dev)
        self.w = _device_values([w for _, w in sizes], torch.int64, dev)
        self.scale = _device_values([1.0 / st for st in strides],
                                    torch.float32, dev)

    def roi_align(self, boxes: torch.Tensor, pooled: int,
                  sampling_ratio: int = 2) -> torch.Tensor:
        lvl = fpn_levels(boxes, self.n_levels)
        scale = self.scale.index_select(0, lvl)[:, None]
        ys, xs = _sample_grid(boxes, scale, pooled, sampling_ratio)
        samples = bilinear_sample(
            self.flat, self.starts.index_select(0, lvl),
            self.h.index_select(0, lvl), self.w.index_select(0, lvl), ys,
            xs)
        return _pool(samples, pooled, sampling_ratio)


def multilevel_roi_align(feats: Sequence[torch.Tensor], boxes: torch.Tensor,
                         strides: Sequence[int], pooled: int = 7,
                         sampling_ratio: int = 2) -> torch.Tensor:
    """FPN level assignment + ROIAlign. feats: [H_l, W_l, C] maps (P2..P5
    order), strides: theirs (4, 8, 16, 32). Returns [R, pooled, pooled,
    C]."""
    return LevelTable(feats, strides).roi_align(boxes, pooled,
                                                sampling_ratio)
