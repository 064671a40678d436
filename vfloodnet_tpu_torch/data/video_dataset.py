"""The video trainer's dataset (counterpart of
``vfloodnet_tpu.data.video_dataset.WaterVideoTrainDataset``, the
reference's ``Water_Image_Train_DS``).

``<root>/train_imgs.txt`` lists subdirectories of ``JPEGImages`` and
``Annotations``; every annotated image becomes a ``clip_n``-frame
pseudo-video (:class:`.transforms.ClipAugmenter`). Sample ``i`` of epoch
``e`` is a pure function of (seed, e, i).
"""

from __future__ import annotations

import os
from glob import glob
from typing import List, Tuple

import numpy as np

from .transforms import ClipAugmenter


def _read_pairs(root: str, dataset_file: str) -> Tuple[List[str], List[str]]:
    imgs, masks = [], []
    with open(os.path.join(root, dataset_file)) as f:
        for line in f:
            name = line.strip()
            if not name:
                continue
            img_dir = os.path.join(root, "JPEGImages", name)
            mask_dir = os.path.join(root, "Annotations", name)
            img_list = sorted(glob(os.path.join(img_dir, "*.jpg"))
                              + glob(os.path.join(img_dir, "*.png")))
            mask_list = sorted(glob(os.path.join(mask_dir, "*.png")))
            if len(img_list) != len(mask_list):
                raise ValueError(f"image/mask count mismatch in {name}")
            imgs += img_list
            masks += mask_list
    return imgs, masks


def _open(path: str, mode: str):
    from PIL import Image
    img = Image.open(path)
    img.load()
    return img.convert(mode)


class WaterVideoTrainDataset:
    """``get(idx, epoch)`` -> (frames [clip_n, S, S, 3] float32 in [0, 1],
    one-hot masks [clip_n, max_obj_n, S, S], obj_n)."""

    def __init__(self, root: str, output_size: int = 400,
                 dataset_file: str = "train_imgs.txt", clip_n: int = 6,
                 max_obj_n: int = 3, seed: int = 0):
        self.img_list, self.mask_list = _read_pairs(root, dataset_file)
        self.augment = ClipAugmenter(output_size, clip_n, max_obj_n)
        self.seed = seed

    def __len__(self) -> int:
        return len(self.img_list)

    def get(self, idx: int, epoch: int = 0):
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch, idx]))
        img = _open(self.img_list[idx], "RGB")
        mask = _open(self.mask_list[idx], "P")
        return self.augment(rng, img, mask)

    __getitem__ = get
