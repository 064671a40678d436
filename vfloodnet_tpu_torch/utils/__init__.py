from .logging import MetricWriter
from .meters import AvgMeter, FrameSecondMeter, gct, save_scripts
from .palette import (COLOR_PALETTE, add_overlay, load_image, load_mask,
                      save_overlay, save_seg_mask)

__all__ = ["AvgMeter", "COLOR_PALETTE", "FrameSecondMeter", "MetricWriter",
           "add_overlay", "gct", "load_image", "load_mask", "save_overlay",
           "save_scripts", "save_seg_mask"]
