from .meters import FrameSecondMeter, gct
from .palette import (COLOR_PALETTE, add_overlay, load_image, load_mask,
                      save_overlay, save_seg_mask)

__all__ = ["COLOR_PALETTE", "FrameSecondMeter", "add_overlay", "gct",
           "load_image", "load_mask", "save_overlay", "save_seg_mask"]
