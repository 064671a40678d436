"""Indexed-PNG masks with the reference palette (water = label 1), and
frame reading. PIL is imported inside the functions that read or write
files, so the package imports where PIL is absent."""

from __future__ import annotations

from typing import Sequence

import numpy as np

# Same palette as the reference (myutils/data.py:14): background black,
# water navy, then green / red, grey filler.
COLOR_PALETTE = [0, 0, 0, 0, 0, 128, 0, 128, 0, 128, 0, 0] + [100, 100, 100] * 252


def save_seg_mask(pred: np.ndarray, seg_path: str,
                  palette: Sequence[int] = COLOR_PALETTE) -> None:
    """Write uint8 labels as an indexed PNG with the palette."""
    from PIL import Image
    img = Image.fromarray(np.asarray(pred, dtype=np.uint8), mode="P")
    img.putpalette(list(palette))
    img.save(seg_path)


def load_image(path: str) -> np.ndarray:
    """Decode an image file as uint8 RGB [H, W, 3]."""
    from PIL import Image
    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"), dtype=np.uint8)


def load_mask(path: str) -> np.ndarray:
    """Read an indexed-PNG mask as uint8 labels [H, W]."""
    from PIL import Image
    with Image.open(path) as img:
        return np.asarray(img.convert("P") if img.mode not in ("P", "L")
                          else img, dtype=np.uint8)
