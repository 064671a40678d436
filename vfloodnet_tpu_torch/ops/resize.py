"""Resize ops (counterpart of ``vfloodnet_tpu.ops.resize``).

- ``bicubic``: torch's own kernel (Keys a=-0.75, half-pixel centres,
  replicated edges, no antialias), which is the kernel the JAX package
  rebuilt as dense matrices. A bf16 input is resized as the JAX package
  resizes it: separably, with the dense [out, in] tap matrices rounded to
  bf16, float32 accumulation, and each pass's result stored in bf16.
- ``nearest``: JAX's half-pixel nearest, ``src = floor((i + 0.5) * in / out)``
  computed in float32 as ``jax.image.resize`` does. Used by the device
  largest-CC cleanup.
- ``nearest_torch``: floor indexing, ``src = floor(i * (in / out))`` in
  float64, as the JAX package computes it. Used for the first-mask downsize.
- ``bilinear``: ``jax.image.resize``'s ``linear`` (half-pixel centres, the
  triangle kernel, weights renormalised at the edges), with ``antialias``
  widening the kernel by the downscale factor as JAX does (PIL's
  semantics; the image model's input resize). Dense [out, in] weight
  matrices built in numpy in float32, as JAX builds them, and contracted
  in float32. Used by the image path.

Both nearests gather with indices computed in numpy exactly as the JAX
package computes them. ``F.interpolate``'s ``nearest-exact`` and ``nearest``
round differently at some sizes (it multiplies by a float32 scale), so
they are not used.

Index and tap tensors are built once per (sizes, method, device) and kept
on the device, so a resize inside the video step makes no host-to-device
copy of its own (and can be captured in a CUDA graph).

OpenCV's ``INTER_LINEAR`` (``cv2.resize``'s default), in numpy on the
host, for the detector's input and its mask pasting, which the JAX
package resizes with cv2 (the card's machine has none):

- :func:`cv2_linear_u8`: the uint8 form, in OpenCV's fixed point, as
  torch integer ops on the image's device (the detector resizes its
  uploaded frame on the card). Sample
  positions ``(i + 0.5) * in / out - 0.5`` in float; 11-bit weights
  ``rint(w * 2048)``; the horizontal pass clamps the sample to the edge
  (weights (1, 0) outside), the vertical one keeps its weights and clamps
  the two rows it reads. The vertical pass is OpenCV's SIMD one: each
  row's sums shifted right by 4, multiplied by the 11-bit weight keeping
  the high 16 bits, added, then ``(x + 2) >> 2``; OpenCV 5.0.0's own
  results on every size tried.
- :func:`cv2_linear_f32`: the float32 form with the same positions and
  float weights, edges clamped alike. OpenCV's float kernels round in
  another order: about 1e-6 of the value apart.

and OpenCV's ``INTER_NEAREST`` (:func:`cv2_nearest`, the person crop's
water mask), a third nearest rule: ``min(floor(i * (1 / fx)), n_in - 1)``
in float64 with ``fx = n_out / n_in``.
"""

from __future__ import annotations

import functools
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


@functools.lru_cache(maxsize=64)
def _nearest_taps(n_in: int, n_out: int, method: str, device: torch.device):
    """:func:`_nearest_index` as an int64 tensor on ``device``, uploaded
    once per (sizes, method, device)."""
    return torch.from_numpy(_nearest_index(n_in, n_out, method)).to(device)


def _linear_matrix(in_size: int, out_size: int, antialias: bool
                   ) -> np.ndarray:
    """Dense [out, in] float32 weights of ``jax.image.resize``'s ``linear``
    (``compute_weight_mat`` with the triangle kernel), in the float32
    arithmetic XLA compiles it to: half-pixel sample positions, the kernel widened by the
    downscale factor under ``antialias``, each output's weights divided by
    their sum, and outputs whose sample lies outside the input zeroed."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1.0)) if antialias else f32(1.0)
    # XLA fuses (i + 0.5) * inv_scale - 0.5 into one FMA inside jit: the
    # exact product less 0.5, rounded once
    sample = ((np.arange(out_size, dtype=f32) + f32(0.5)).astype(np.float64)
              * np.float64(inv_scale) - 0.5).astype(f32)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None]) \
        / f32(kernel_scale)
    w = np.maximum(f32(0), f32(1) - np.abs(x)).astype(f32)   # [in, out]
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0)).T.astype(f32)


@functools.lru_cache(maxsize=32)
def _linear_taps(in_size: int, out_size: int, antialias: bool,
                 device: torch.device):
    """The [in, out] transpose of :func:`_linear_matrix` on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(
        _linear_matrix(in_size, out_size, antialias).T)).to(device)


def _cubic_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Dense [out, in] float32 matrix of torch's bicubic resize (the JAX
    package's ``_torch_cubic_matrix``)."""
    a = np.float32(-0.75)
    src = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) \
        * np.float32(in_size / out_size) - np.float32(0.5)
    i0 = np.floor(src)
    t = src - i0

    def kernel(x):
        x = np.abs(x)
        near = ((a + 2) * x - (a + 3)) * x * x + 1
        far = a * (((x - 5) * x + 8) * x - 4)
        return np.where(x <= 1, near, np.where(x < 2, far, 0)).astype(
            np.float32)

    m = np.zeros((out_size, in_size), np.float32)
    rows = np.arange(out_size)
    for k in (-1, 0, 1, 2):
        idx = np.clip(i0 + k, 0, in_size - 1).astype(np.int64)
        np.add.at(m, (rows, idx), kernel(t - k))
    return m


@functools.lru_cache(maxsize=16)
def _cubic_taps(in_size: int, out_size: int, device: torch.device):
    """The [in, out] transpose of :func:`_cubic_matrix` with its taps
    rounded to bf16, held as float32 on ``device``: built and uploaded once
    per size pair (a step resizes with the same four), not every frame."""
    m = torch.from_numpy(_cubic_matrix(in_size, out_size)).to(torch.bfloat16)
    return m.float().T.contiguous().to(device)


def _bicubic_bf16(x: torch.Tensor, out_hw, h_ax: int, w_ax: int):
    """Separable bicubic of a bf16 tensor: the H pass, then the W pass.
    Each pass makes the resized axis the last of a contiguous float32 copy,
    so every other axis (streams, rows, channels) folds into the rows of
    one product; a strided operand would make ``@`` a batched product of
    [3, n_in] matrices, many times slower."""
    for ax, n_out in ((h_ax, out_hw[0]), (w_ax, out_hw[1])):
        if x.shape[ax] == n_out:
            continue
        taps = _cubic_taps(x.shape[ax], n_out, x.device)
        y = x.movedim(ax, -1).to(torch.float32,
                                 memory_format=torch.contiguous_format) @ taps
        x = y.to(torch.bfloat16).movedim(-1, ax)
    return x


def _bilinear(x: torch.Tensor, out_hw, h_ax: int, w_ax: int,
              antialias: bool) -> torch.Tensor:
    """Separable ``jax.image.resize`` linear in float32 (float64 for a
    float64 ``x``): the H pass, then the W pass; the result in ``x``'s
    dtype."""
    y = x if x.dtype == torch.float64 else x.float()
    for ax, n_out in ((h_ax, out_hw[0]), (w_ax, out_hw[1])):
        if y.shape[ax] == n_out:
            continue
        taps = _linear_taps(y.shape[ax], n_out, antialias,
                            y.device).to(y.dtype)
        y = (y.movedim(ax, -1) @ taps).movedim(-1, ax)
    return y.to(x.dtype)


def resize(x: torch.Tensor, out_hw: Tuple[int, int], method: str = "bicubic",
           spatial_axes: Tuple[int, int] = (-3, -2),
           antialias: bool = False) -> torch.Tensor:
    """Resize the two spatial axes of ``x`` (default NHWC) to ``out_hw``.
    ``method`` in {bicubic, bilinear, nearest, nearest_torch};
    ``antialias`` applies to ``bilinear`` only (the JAX package's bicubic
    is torch's, without antialias)."""
    h_ax = spatial_axes[0] % x.ndim
    w_ax = spatial_axes[1] % x.ndim
    if method in ("nearest", "nearest_torch"):
        for ax, n_out in ((h_ax, out_hw[0]), (w_ax, out_hw[1])):
            if x.shape[ax] != n_out:
                x = x.index_select(ax, _nearest_taps(x.shape[ax], n_out,
                                                     method, x.device))
        return x
    if method == "bilinear":
        return _bilinear(x, out_hw, h_ax, w_ax, antialias)
    if method != "bicubic":
        raise ValueError(f"unknown resize method {method!r}")
    if antialias:
        raise ValueError("antialias is ported for bilinear only")
    if tuple(x.shape[a] for a in (h_ax, w_ax)) == tuple(out_hw):
        return x
    if x.dtype == torch.bfloat16:
        return _bicubic_bf16(x, out_hw, h_ax, w_ax)
    # move the spatial axes last, fold the rest into the channel axis
    y = x.movedim((h_ax, w_ax), (-2, -1))
    lead = y.shape[:-2]
    y = y.reshape((1, -1) + y.shape[-2:])
    y = F.interpolate(y, size=tuple(out_hw), mode="bicubic",
                      align_corners=False)
    y = y.reshape(lead + tuple(out_hw))
    return y.movedim((-2, -1), (h_ax, w_ax))


def _cv2_taps(n_in: int, n_out: int, clamp: bool):
    """OpenCV's linear taps along one axis: (first index, second index,
    float32 weights of each); ``clamp`` (the horizontal pass) puts a sample
    outside the input on the edge pixel with weights (1, 0), otherwise
    only the indices are clamped."""
    scale = 1.0 / (np.float64(n_out) / np.float64(n_in))
    f = ((np.arange(n_out) + 0.5) * scale - 0.5).astype(np.float32)
    i0 = np.floor(f).astype(np.int64)
    f = (f - i0.astype(np.float32)).astype(np.float32)
    if clamp:
        edge = (i0 < 0) | (i0 >= n_in - 1)
        f[edge] = 0
        i0 = np.clip(i0, 0, n_in - 1)
    i1 = np.clip(i0 + 1, 0, n_in - 1)
    i0 = np.clip(i0, 0, n_in - 1)
    return i0, i1, (np.float32(1) - f).astype(np.float32), f


@functools.lru_cache(maxsize=16)
def _cv2_u8_taps(n_in: int, n_out: int, clamp: bool, device: torch.device):
    """:func:`_cv2_taps` as int64 indices and 11-bit int32 weights on
    ``device``, made once per (sizes, axis kind, device)."""
    i0, i1, w0, w1 = _cv2_taps(n_in, n_out, clamp)
    return tuple(torch.from_numpy(v).to(device) for v in (
        i0, i1, np.rint(w0 * 2048).astype(np.int32),
        np.rint(w1 * 2048).astype(np.int32)))


def cv2_linear_u8(img: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """``cv2.resize(img, (w, h))`` of a uint8 [H, W] or [H, W, C] tensor,
    on its device (integer arithmetic: the same bytes on the card and the
    CPU)."""
    h, w = img.shape[:2]
    oh, ow = out_hw
    if (h, w) == (oh, ow):
        return img.clone()
    chan = (1,) * (img.ndim - 2)
    x0, x1, a0, a1 = _cv2_u8_taps(w, ow, True, img.device)
    y0, y1, b0, b1 = _cv2_u8_taps(h, oh, False, img.device)
    src = img.to(torch.int32)
    rows = (src.index_select(1, x0) * a0.reshape((1, ow) + chan)
            + src.index_select(1, x1) * a1.reshape((1, ow) + chan))
    acc = ((((rows.index_select(0, y0) >> 4) * b0.reshape((oh, 1) + chan))
            >> 16)
           + (((rows.index_select(0, y1) >> 4) * b1.reshape((oh, 1) + chan))
              >> 16))
    return ((acc + 2) >> 2).clamp(0, 255).to(torch.uint8)


def cv2_linear_f32(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, (w, h))`` of a float32 [H, W] map."""
    h, w = img.shape
    oh, ow = out_hw
    img = img.astype(np.float32)
    x0, x1, a0, a1 = _cv2_taps(w, ow, clamp=True)
    y0, y1, b0, b1 = _cv2_taps(h, oh, clamp=False)
    rows = img[:, x0] * a0 + img[:, x1] * a1
    return (rows[y0] * b0[:, None] + rows[y1] * b1[:, None]).astype(
        np.float32)


def _fma32(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """``a * b + c`` of float32 arrays rounded once to float32 (a fused
    multiply-add; the float64 product of two float32 values is exact)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def cv2_linear_float(img: np.ndarray, out_hw: Tuple[int, int]
                     ) -> np.ndarray:
    """``cv2.resize(img, (w, h))`` of a float32 [H, W] or [H, W, C] image,
    as OpenCV 5.0.0 computes it for a source at least 25 pixels wide
    (narrower ones, enlarged more than about 9 times, take another
    kernel): sample positions ``(i + 0.5) * in / out - 0.5`` in float64,
    the fraction rounded to float32, indices clamped to the edge, and each
    pass a fused ``s0 + frac * (s1 - s0)``, the rows first."""
    img = img.astype(np.float32)
    chan = (1,) * (img.ndim - 2)

    def taps(n_in, n_out):
        f = (np.arange(n_out) + 0.5) * (np.float64(n_in) / n_out) - 0.5
        i0 = np.floor(f)
        frac = (f - i0).astype(np.float32)
        i0 = i0.astype(np.int64)
        return (np.clip(i0, 0, n_in - 1), np.clip(i0 + 1, 0, n_in - 1),
                frac)

    x0, x1, a = taps(img.shape[1], out_hw[1])
    y0, y1, b = taps(img.shape[0], out_hw[0])
    s0 = img[:, x0]
    rows = _fma32(a.reshape((1, -1) + chan), img[:, x1] - s0, s0)
    r0 = rows[y0]
    return _fma32(b.reshape((-1, 1) + chan), rows[y1] - r0, r0)


def _cv2_nearest_index(n_in: int, n_out: int) -> np.ndarray:
    inv = 1.0 / (np.float64(n_out) / np.float64(n_in))
    return np.minimum(np.floor(np.arange(n_out) * inv).astype(np.int64),
                      n_in - 1)


def cv2_nearest(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=cv2.INTER_NEAREST)`` of an
    [H, W] or [H, W, C] array."""
    h, w = img.shape[:2]
    return img[_cv2_nearest_index(h, out_hw[0])][
        :, _cv2_nearest_index(w, out_hw[1])]
