"""Homography estimation and perspective warps (counterpart of
``vfloodnet_tpu.ops.homography``, with the warps that the JAX package takes
from OpenCV).

:func:`find_homography`, :func:`perspective_transform` and
:func:`warp_perspective_nearest` are the JAX package's numpy functions.
:func:`warp_perspective` and :func:`warp_perspective_mask` rectify a frame
(bilinear) and a mask (nearest) as ``cv2.warpPerspective`` does with a
zero border, as torch ops on the tensor's device, so the card needs no
OpenCV: the inverse map in float64, then for bilinear float32 weights at
the exact positions and a rounded uint8 result (as OpenCV 5 samples; its
4.x releases rounded positions to 1/32 px), for nearest the position
rounded half to even. :class:`BilinearMap` is the shared gather; a
stream of frames of one size reuses the map of :func:`perspective_map`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def find_homography(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Normalized DLT: least-squares homography mapping src -> dst.

    src, dst: [N, 2] with N >= 4. Returns [3, 3] with h22 == 1.
    """
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    n = src.shape[0]
    if n < 4:
        raise ValueError("need >= 4 point correspondences")

    def normalize(pts):
        c = pts.mean(axis=0)
        d = np.sqrt(((pts - c) ** 2).sum(axis=1)).mean()
        s = np.sqrt(2.0) / max(d, 1e-12)
        t = np.array([[s, 0, -s * c[0]], [0, s, -s * c[1]], [0, 0, 1]])
        ph = np.concatenate([pts, np.ones((n, 1))], axis=1) @ t.T
        return ph[:, :2], t

    s_n, t_s = normalize(src)
    d_n, t_d = normalize(dst)

    a = np.zeros((2 * n, 9))
    for i in range(n):
        x, y = s_n[i]
        u, v = d_n[i]
        a[2 * i] = [-x, -y, -1, 0, 0, 0, u * x, u * y, u]
        a[2 * i + 1] = [0, 0, 0, -x, -y, -1, v * x, v * y, v]
    _, _, vt = np.linalg.svd(a)
    h_n = vt[-1].reshape(3, 3)
    h = np.linalg.inv(t_d) @ h_n @ t_s
    return h / h[2, 2]


def perspective_transform(pts: np.ndarray, h: np.ndarray) -> np.ndarray:
    """Apply homography to [N, 2] points."""
    pts = np.asarray(pts, np.float64)
    ph = np.concatenate([pts, np.ones((pts.shape[0], 1))], axis=1)
    out = ph @ np.asarray(h).T
    return out[:, :2] / out[:, 2:3]


def warp_perspective_nearest(img: np.ndarray, h: np.ndarray,
                             out_hw=None) -> np.ndarray:
    """Inverse-mapped nearest-neighbour perspective warp (numpy)."""
    hh, ww = img.shape[:2] if out_hw is None else out_hw
    ys, xs = np.mgrid[0:hh, 0:ww]
    pts = np.stack([xs.ravel(), ys.ravel()], axis=1).astype(np.float64)
    src = perspective_transform(pts, np.linalg.inv(np.asarray(h)))
    sx = np.round(src[:, 0]).astype(int)
    sy = np.round(src[:, 1]).astype(int)
    ok = (sx >= 0) & (sx < img.shape[1]) & (sy >= 0) & (sy < img.shape[0])
    out = np.zeros((hh, ww) + img.shape[2:], img.dtype)
    out.reshape(hh * ww, *img.shape[2:])[ok] = img[sy[ok], sx[ok]]
    return out


def _border_index(i: torch.Tensor, n: int, border: str) -> torch.Tensor:
    """OpenCV's ``borderInterpolate`` of integer positions: 'reflect'
    (``fedcba|abcdef|fedcba``) or 'replicate' (clamp); 'constant' leaves
    them (the caller masks what lies outside)."""
    if border == "reflect":
        q = torch.remainder(i, 2 * n)
        return torch.where(q >= n, 2 * n - 1 - q, q)
    if border == "replicate":
        return i.clamp(0, n - 1)
    return i


class BilinearMap:
    """Bilinear sampling of images of one size ([H, W] or [H, W, C]) at
    fixed float source positions ``sx``, ``sy`` (tensors of the output's
    shape): four source indices and float32 weights per output pixel, made
    once, so each image costs one gather and a weighted sum. Samples
    outside the image are 0 ('constant', weight 0), reflected or clamped;
    a uint8 image is rounded back to uint8."""

    def __init__(self, sx: torch.Tensor, sy: torch.Tensor,
                 in_hw: Tuple[int, int], border: str = "constant"):
        h, w = self.in_hw = tuple(in_hw)
        self.out_shape = tuple(sx.shape)
        x0, y0 = torch.floor(sx), torch.floor(sy)
        fx = (sx - x0).to(torch.float32)
        fy = (sy - y0).to(torch.float32)
        ix, iy = x0.to(torch.int64), y0.to(torch.int64)
        idx, wts = [], []
        for dy, wy in ((0, 1.0 - fy), (1, fy)):
            for dx, wx in ((0, 1.0 - fx), (1, fx)):
                yy = _border_index(iy + dy, h, border)
                xx = _border_index(ix + dx, w, border)
                wk = wy * wx
                if border == "constant":
                    inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
                    yy, xx = torch.where(inside, yy, 0), torch.where(
                        inside, xx, 0)
                    wk = wk * inside
                idx.append((yy * w + xx).reshape(-1))
                wts.append(wk.reshape(-1))
        self.idx = torch.cat(idx)                  # [4 * N]
        self.weights = torch.stack(wts)[..., None]  # [4, N, 1]

    def __call__(self, img: torch.Tensor) -> torch.Tensor:
        h, w = self.in_hw
        flat = img.reshape(h * w, -1)
        samples = flat.index_select(0, self.idx).reshape(
            4, -1, flat.shape[1]).to(torch.float32)
        acc = (samples * self.weights).sum(dim=0)
        if img.dtype == torch.uint8:
            acc = acc.round().clamp(0, 255)
        return acc.to(img.dtype).reshape(self.out_shape + img.shape[2:])


def _inverse_positions(h: np.ndarray, out_hw: Tuple[int, int], device
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Source positions (float64) of every output pixel under the inverse
    of ``h``. The matrix enters as Python floats, so nothing is copied to
    the device."""
    a = [float(v) for v in np.linalg.inv(np.asarray(h, np.float64)).ravel()]
    hh, ww = out_hw
    y = torch.arange(hh, dtype=torch.float64, device=device)[:, None]
    x = torch.arange(ww, dtype=torch.float64, device=device)[None, :]
    wgt = a[6] * x + a[7] * y + a[8]
    inv = torch.where(wgt != 0, 1.0 / wgt, torch.zeros_like(wgt))
    return ((a[0] * x + a[1] * y + a[2]) * inv,
            (a[3] * x + a[4] * y + a[5]) * inv)


def perspective_map(h: np.ndarray, in_hw: Tuple[int, int],
                    out_hw: Optional[Tuple[int, int]] = None,
                    device="cpu") -> BilinearMap:
    """The :class:`BilinearMap` of ``cv2.warpPerspective(img, h, (w, h))``
    (bilinear, zero border) for images of ``in_hw``: made once per
    homography and frame size, applied to every frame."""
    out_hw = tuple(in_hw) if out_hw is None else out_hw
    sx, sy = _inverse_positions(h, out_hw, device)
    return BilinearMap(sx, sy, in_hw, "constant")


def warp_perspective(img: torch.Tensor, h: np.ndarray,
                     out_hw: Optional[Tuple[int, int]] = None
                     ) -> torch.Tensor:
    """``cv2.warpPerspective(img, h, (w, h))``: bilinear, zero border, on
    ``img``'s device; ``img`` [H, W] or [H, W, C], uint8 or float."""
    return perspective_map(h, img.shape[:2], out_hw, img.device)(img)


def warp_perspective_mask(mask: torch.Tensor, h: np.ndarray,
                          out_hw: Optional[Tuple[int, int]] = None
                          ) -> torch.Tensor:
    """``cv2.warpPerspective(mask, h, (w, h), flags=INTER_NEAREST)``:
    the nearest source pixel, 0 outside, on ``mask``'s device."""
    hh, ww = tuple(mask.shape[:2]) if out_hw is None else out_hw
    sx, sy = (p.round().to(torch.int64)
              for p in _inverse_positions(h, (hh, ww), mask.device))
    inside = (sx >= 0) & (sx < mask.shape[1]) & (sy >= 0) & \
        (sy < mask.shape[0])
    idx = torch.where(inside, sy * mask.shape[1] + sx, 0).reshape(-1)
    flat = mask.reshape(mask.shape[0] * mask.shape[1], -1)
    out = flat.index_select(0, idx).reshape((hh, ww) + mask.shape[2:])
    keep = inside.reshape((hh, ww) + (1,) * (mask.dim() - 2))
    return out * keep.to(mask.dtype)
