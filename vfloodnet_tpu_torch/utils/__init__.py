from .palette import COLOR_PALETTE, load_image, load_mask, save_seg_mask

__all__ = ["COLOR_PALETTE", "load_image", "load_mask", "save_seg_mask"]
