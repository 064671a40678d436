"""The image trainer's dataset (counterpart of
``vfloodnet_tpu.data.image_dataset.WaterImageDataset``, the reference's
``WaterDataset``).

``train_offline`` lists the ``JPEGImages``/``Annotations`` pairs of the
subdirectories that ``<root>/<dataset_file>`` names and augments each
(colour jitter, affine, resized crop, optionally morphological mask noise);
``eval`` lists a plain folder of images and resizes them. Sample ``idx`` of
epoch ``e`` is a pure function of (seed, e, idx). numpy, with PIL imported
inside the functions that read or warp images.
"""

from __future__ import annotations

import os
from glob import glob
from typing import Optional, Tuple

import numpy as np

from .transforms import (color_jitter, random_affine_pair,
                         random_mask_perturbation, random_resized_crop_pair)
from .video_dataset import _open, _read_pairs


class WaterImageDataset:
    """``get(idx, epoch)`` -> (image [S, S, 3] float32 in [0, 1], mask
    [S, S] float32 in {0, 1}, or None in ``eval`` mode)."""

    def __init__(self, mode: str, root: str, input_size: int = 416,
                 dataset_file: str = "train_imgs.txt", seed: int = 0,
                 perturb_masks: bool = False):
        if mode not in ("train_offline", "eval"):
            raise ValueError(mode)
        self.mode = mode
        self.input_size = input_size
        self.seed = seed
        self.perturb_masks = perturb_masks
        if mode == "train_offline":
            self.img_list, self.mask_list = _read_pairs(root, dataset_file)
        else:
            self.img_list = sorted(glob(os.path.join(root, "*.jpg"))
                                   + glob(os.path.join(root, "*.png")))
            self.mask_list = []

    def __len__(self) -> int:
        return len(self.img_list)

    def get(self, idx: int, epoch: int = 0
            ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        from PIL import Image
        img = _open(self.img_list[idx], "RGB")
        if self.mode == "eval":
            size = (self.input_size, self.input_size)
            arr = np.asarray(img.resize(size, Image.BILINEAR),
                             np.float32) / 255.0
            return arr, None

        mask = _open(self.mask_list[idx], "P")
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch, idx]))
        img = color_jitter(rng, img, brightness=0.55, contrast=0.8,
                           saturation=0.0, hue=0.05)
        img, mask = random_affine_pair(rng, img, mask)
        img, mask = random_resized_crop_pair(rng, img, mask, self.input_size)
        mask_np = (np.array(mask, np.uint8) > 0).astype(np.float32)
        if self.perturb_masks:
            mask_np = random_mask_perturbation(rng, mask_np)
        return np.asarray(img, np.float32) / 255.0, mask_np

    __getitem__ = get
