"""Depth and segmentation plots (counterpart of
``vfloodnet_tpu.utils.visualize``).

``plot_seg`` writes the mask's overlay as an RGB PNG through
:func:`..native.write_rgb_png`, so it needs no PIL; ``plot_depth`` draws
contour-filled depth over the image with matplotlib, imported inside it:
where matplotlib is absent (the card's machine), it raises
``ImportError`` there and nowhere else.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .. import native
from .palette import COLOR_PALETTE, add_overlay


class Visualizer:
    def __init__(self, out_dpi: int = 120):
        self.out_dpi = out_dpi

    def plot_seg(self, img_bgr: np.ndarray, mask: np.ndarray,
                 out_path: str, alpha: float = 0.4) -> None:
        """The mask's overlay on the BGR uint8 image, written as RGB."""
        overlay = add_overlay(img_bgr, mask, COLOR_PALETTE, alpha)
        native.write_rgb_png(out_path, overlay[..., ::-1])

    def plot_depth(self, img_bgr: np.ndarray, depth: np.ndarray,
                   out_path: str, levels: int = 10,
                   mask: Optional[np.ndarray] = None,
                   alpha: float = 0.55) -> None:
        """Contour-filled depth over the image (reference
        plot_depth.py:39-76). depth: [H, W] float (e.g. cm); NaN or
        negative = no estimate; ``mask`` optionally restricts the fill."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        h, w = depth.shape
        fig, ax = plt.subplots(figsize=(w / self.out_dpi, h / self.out_dpi),
                               dpi=self.out_dpi)
        ax.imshow(img_bgr[..., ::-1])
        d = np.array(depth, np.float64)
        if mask is not None:
            d = np.where(mask > 0, d, np.nan)
        d = np.where(d >= 0, d, np.nan)
        if np.isfinite(d).any():
            cs = ax.contourf(d, levels=levels, cmap="turbo", alpha=alpha)
            cbar = fig.colorbar(cs, ax=ax, fraction=0.035)
            cbar.set_label("water depth (cm)")
        ax.set_axis_off()
        fig.tight_layout(pad=0)
        fig.savefig(out_path, dpi=self.out_dpi, bbox_inches="tight")
        plt.close(fig)
