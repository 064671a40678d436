"""Indexed-PNG masks with the reference palette (water = label 1), frame
reading, and mask overlays. Masks are written and read by
:mod:`..native` (numpy and ``zlib``), so they need no PIL; PIL is imported
inside the functions that decode frames, write overlays or read a PNG
that is not an 8-bit palette or grey image, so the package imports where
PIL is absent; the overlay itself is numpy."""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .. import native

# Same palette as the reference (myutils/data.py:14): background black,
# water navy, then green / red, grey filler.
COLOR_PALETTE = [0, 0, 0, 0, 0, 128, 0, 128, 0, 128, 0, 0] + [100, 100, 100] * 252


def save_seg_mask(pred: np.ndarray, seg_path: str,
                  palette: Sequence[int] = COLOR_PALETTE) -> None:
    """Write uint8 labels as an indexed PNG with the palette
    (:func:`..native.write_palette_png`)."""
    native.write_palette_png(seg_path, np.asarray(pred, dtype=np.uint8),
                             palette)


def load_image(path: str) -> np.ndarray:
    """Decode an image file as uint8 RGB [H, W, 3]."""
    from PIL import Image
    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"), dtype=np.uint8)


def load_mask(path: str) -> np.ndarray:
    """Read an indexed-PNG mask as uint8 labels [H, W]: an 8-bit palette
    or grey PNG through :func:`..native.read_palette_png`, another file
    (a JPEG, an RGB PNG) through PIL, converted to a palette image."""
    if path.endswith(".png"):
        try:
            return native.read_palette_png(path)
        except native.UnsupportedPNG:
            pass
    from PIL import Image
    with Image.open(path) as img:
        return np.asarray(img.convert("P") if img.mode not in ("P", "L")
                          else img, dtype=np.uint8)


def _dilate(mask: np.ndarray) -> np.ndarray:
    """One-pixel 4-neighbour dilation of a boolean mask."""
    out = mask.copy()
    out[1:, :] |= mask[:-1, :]
    out[:-1, :] |= mask[1:, :]
    out[:, 1:] |= mask[:, :-1]
    out[:, :-1] |= mask[:, 1:]
    return out


def add_overlay(img_bgr: np.ndarray, mask: np.ndarray,
                colors: Sequence[int] = COLOR_PALETTE,
                alpha: float = 0.4, cscale: float = 1.0) -> np.ndarray:
    """Blend each label's palette colour onto a BGR uint8 image (the
    image at weight ``alpha``) and draw each label's outline in black:
    the pixels just outside it (reference myutils/data.py:56-75)."""
    out = img_bgr.copy()
    color_table = np.atleast_2d(np.reshape(
        np.asarray(colors, dtype=np.float64), (-1, 3))) * cscale
    for label in np.unique(mask):
        if label == 0:
            continue
        binary = mask == label
        col = color_table[label][::-1] * (1.0 - alpha)
        out[binary] = (img_bgr[binary] * alpha + col).astype(np.uint8)
        contour = _dilate(binary) ^ binary
        out[contour, :] = 0
    return out


def save_overlay(img_rgb: np.ndarray, mask: np.ndarray, overlay_path: str,
                 colors: Sequence[int] = COLOR_PALETTE,
                 alpha: float = 0.4, cscale: float = 1.0) -> None:
    """Write :func:`add_overlay` of an RGB image (uint8, or float in
    [0, 1]) as a PNG."""
    from PIL import Image
    img_rgb = np.asarray(img_rgb)
    if img_rgb.dtype != np.uint8:
        img_rgb = (img_rgb * 255).astype(np.uint8)
    overlay = add_overlay(np.ascontiguousarray(img_rgb[..., ::-1]),
                          np.asarray(mask), colors, alpha, cscale)
    Image.fromarray(np.ascontiguousarray(overlay[..., ::-1])).save(
        overlay_path)
