"""Atlantis evaluation: PSPNet's 56 ATLANTIS classes mapped to binary water
(counterpart of the root ``test_atlantis_model.py``).

For each ``*.jpg`` and ``*.png`` of ``--data-directory``: the image as
float32 in [0, 1], shrunk first if it is larger than the padding
(OpenCV's float ``INTER_LINEAR`` at ``(int(w * scale), int(h * scale))``,
rebuilt by :func:`..ops.resize.cv2_linear_float`), padded at the top and
the right to ``--padding-size`` square, normalised with the ImageNet mean
and std, PSPNet's ``logits`` upsampled (``jax.image.resize``'s
``linear``) to the padded size, the argmax (first index on ties) as
uint8, the padding stripped (when the right pad is 0 every column is
kept, as the JAX harness keeps them), then ``{name}_color.png``, the
labels in the palette, and ``{name}_water.png``, the 13 water classes
as a mask over the image (``add_overlay``, written by
:func:`..native.write_rgb_png`: no PIL needed to write).

Weights: a flat ``.npz`` of the JAX package's variables
(:func:`.loaders.load_pspnet`); without a file, seeded weights and a
warning. An orbax folder raises.

Run ``python -m vfloodnet_tpu_torch.pipelines.atlantis --data-directory
IMAGES --restore-from WEIGHTS.npz [--device cpu]`` (the flags of
``test_atlantis_model.py``, plus ``--device``).
"""

from __future__ import annotations

import argparse
import os
from glob import glob
from typing import Tuple

import numpy as np
import torch

from .. import native
from ..models.linknet import IMAGENET_MEAN, IMAGENET_STD
from ..ops.resize import cv2_linear_float, resize
from ..utils import add_overlay, gct, load_image, save_seg_mask
from .loaders import load_pspnet

# ATLANTIS water-related class ids (reference test_atlantis_model.py:16)
WATER_LABELS = (15, 16, 17, 18, 19, 31, 33, 34, 35, 37, 44, 53, 54)


def pad_image(img: np.ndarray, pad: int
              ) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """``(padded, img, top_pad, right_pad)``: float32 [H, W, 3] ``img``
    (shrunk to fit first if either side exceeds ``pad``) at the bottom
    left of a zero ``pad`` x ``pad`` image."""
    h, w = img.shape[:2]
    top_pad, right_pad = pad - h, pad - w
    if top_pad < 0 or right_pad < 0:
        scale = pad / max(h, w)
        img = cv2_linear_float(img, (int(h * scale), int(w * scale)))
        h, w = img.shape[:2]
        top_pad, right_pad = pad - h, pad - w
    padded = np.zeros((pad, pad, 3), np.float32)
    padded[top_pad:, :w] = img
    return padded, img, top_pad, right_pad


class AtlantisEvaluator:
    """The harness's work on one image with a PSPNet on its device."""

    def __init__(self, model, padding_size: int = 768,
                 num_classes: int = 56):
        self.model = model
        self.pad = padding_size
        self.device = next(model.parameters()).device
        self.mean = torch.tensor(IMAGENET_MEAN, device=self.device)
        self.std = torch.tensor(IMAGENET_STD, device=self.device)
        self.water_set = np.zeros(num_classes, bool)
        self.water_set[list(WATER_LABELS)] = True

    @torch.no_grad()
    def labels(self, padded: torch.Tensor) -> torch.Tensor:
        """uint8 labels [pad, pad] on the device of a padded float32
        [pad, pad, 3] image on the device."""
        x = ((padded - self.mean) / self.std).permute(2, 0, 1)[None]
        _, logits = self.model(x)
        up = resize(logits, (self.pad, self.pad), "bilinear",
                    spatial_axes=(-2, -1), antialias=True)
        return up[0].argmax(dim=0).to(torch.uint8)

    def predict(self, img: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """``(labels [h, w] uint8, the image they label)`` of a float32
        [H, W, 3] image in [0, 1]; the image is the input, or its shrunk
        copy if it was larger than the padding."""
        padded, img, top_pad, right_pad = pad_image(img, self.pad)
        pred = self.labels(torch.from_numpy(padded).to(self.device))
        pred = pred.cpu().numpy()
        w = img.shape[1]
        pred = pred[top_pad:, :w] if right_pad else pred[top_pad:]
        return pred, img

    def water(self, pred: np.ndarray) -> np.ndarray:
        """The binary water mask uint8 of labels ``pred``."""
        return self.water_set[pred].astype(np.uint8)

    def write(self, name: str, img: np.ndarray, pred: np.ndarray,
              save_path: str) -> None:
        """``{name}_color.png`` (the labels) and ``{name}_water.png`` (the
        water mask over the image) under ``save_path``."""
        save_seg_mask(pred, os.path.join(save_path, f"{name}_color.png"))
        bgr = (img[..., ::-1] * 255).astype(np.uint8)
        overlay = add_overlay(np.ascontiguousarray(bgr), self.water(pred))
        native.write_rgb_png(os.path.join(save_path, f"{name}_water.png"),
                             overlay[..., ::-1])


def get_arguments(argv=None):
    p = argparse.ArgumentParser(
        description="flowtide (PyTorch/CUDA): PSPNet on ATLANTIS")
    p.add_argument("--model", type=str, default="PSPNet")
    p.add_argument("--num-classes", type=int, default=56)
    p.add_argument("--padding-size", type=int, default=768)
    p.add_argument("--data-directory", type=str, default="./atlantis")
    p.add_argument("--restore-from", type=str,
                   default="./records/atlantis_pspnet_tpu")
    p.add_argument("--save-path", type=str,
                   default="./output/atlantis_model_test_results")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' or 'cpu'.")
    return p.parse_args(argv)


def main(args) -> None:
    if args.model != "PSPNet":
        raise NotImplementedError(args.model)
    model = load_pspnet(args.restore_from, args.num_classes, args.device)
    evaluator = AtlantisEvaluator(model, args.padding_size, args.num_classes)
    os.makedirs(args.save_path, exist_ok=True)
    paths = sorted(glob(os.path.join(args.data_directory, "*.jpg"))
                   + glob(os.path.join(args.data_directory, "*.png")))
    for path in paths:
        name = os.path.splitext(os.path.basename(path))[0]
        img = np.asarray(load_image(path), np.float32) / 255.0
        pred, img = evaluator.predict(img)
        evaluator.write(name, img, pred, args.save_path)
    print(gct(), f"Processed {len(paths)} images -> {args.save_path}")


if __name__ == "__main__":
    main(get_arguments())
