"""Paired image and mask augmentations for the video trainer (counterpart
of ``vfloodnet_tpu.data.transforms``, whose numpy and PIL arithmetic this
repeats call for call, so a clip is bit for bit the JAX package's).

Flip, colour jitter, affine and resized crop applied alike to an image
(bicubic) and its mask (nearest), and the one-hot encoding with shuffled
object ids (the reference's video transforms and ``Water_DS.py``). Every
function takes a ``numpy.random.Generator``, so a sample is a pure
function of (seed, epoch, index). PIL is imported inside the functions
that use it: the card's machine has none.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np


def random_hflip_pair(rng: np.random.Generator, img, mask, p: float = 0.3):
    """RandomHorizontalFlip(0.3) of an image and its mask."""
    from PIL import Image
    if rng.random() < p:
        return (img.transpose(Image.FLIP_LEFT_RIGHT),
                mask.transpose(Image.FLIP_LEFT_RIGHT))
    return img, mask


def color_jitter(rng: np.random.Generator, img, brightness: float = 0.1,
                 contrast: float = 0.1, saturation: float = 0.1,
                 hue: float = 0.03):
    """ColorJitter(0.1, 0.1, 0.1, 0.03): brightness, contrast and
    saturation factors in [1 - s, 1 + s], then a hue shift in HSV."""
    from PIL import Image, ImageEnhance

    def factor(span):
        return float(rng.uniform(max(0.0, 1.0 - span), 1.0 + span))

    img = ImageEnhance.Brightness(img).enhance(factor(brightness))
    img = ImageEnhance.Contrast(img).enhance(factor(contrast))
    img = ImageEnhance.Color(img).enhance(factor(saturation))
    if hue > 0:
        shift = rng.uniform(-hue, hue)
        hsv = np.array(img.convert("HSV"), np.int16)
        hsv[..., 0] = (hsv[..., 0] + int(shift * 255)) % 256
        img = Image.fromarray(hsv.astype(np.uint8), "HSV").convert("RGB")
    return img


def _affine_matrix(center, angle, translate, scale, shear):
    """The inverse affine (output -> input) of T(center + translate) R
    Shear Scale T(-center), as PIL's ``Image.transform`` takes it."""
    rot = math.radians(angle)
    sx, sy = (math.radians(s) for s in shear)
    cx, cy = center
    tx, ty = translate
    a = math.cos(rot - sy) / math.cos(sy)
    b = -math.cos(rot - sy) * math.tan(sx) / math.cos(sy) - math.sin(rot)
    c = math.sin(rot - sy) / math.cos(sy)
    d = -math.sin(rot - sy) * math.tan(sx) / math.cos(sy) + math.cos(rot)
    m = [d, -b, 0.0, -c, a, 0.0]
    m = [x / scale for x in m]
    m[2] += m[0] * (-cx - tx) + m[1] * (-cy - ty)
    m[5] += m[3] * (-cx - tx) + m[4] * (-cy - ty)
    m[2] += cx
    m[5] += cy
    return m


def random_affine_pair(rng: np.random.Generator, img, mask,
                       degrees: float = 20.0,
                       translate: Tuple[float, float] = (0.1, 0.1),
                       scale: Tuple[float, float] = (0.9, 1.1),
                       shear: float = 10.0):
    """RandomAffine(20, (0.1, 0.1), (0.9, 1.1), 10): the image bicubic,
    the mask nearest."""
    from PIL import Image
    w, h = img.size
    angle = float(rng.uniform(-degrees, degrees))
    max_dx, max_dy = translate[0] * w, translate[1] * h
    tr = (float(rng.uniform(-max_dx, max_dx)),
          float(rng.uniform(-max_dy, max_dy)))
    sc = float(rng.uniform(scale[0], scale[1]))
    sh = (float(rng.uniform(-shear, shear)), 0.0)
    m = _affine_matrix((w * 0.5, h * 0.5), angle, tr, sc, sh)
    img = img.transform((w, h), Image.AFFINE, m, resample=Image.BICUBIC)
    mask = mask.transform((w, h), Image.AFFINE, m, resample=Image.NEAREST)
    return img, mask


def random_resized_crop_pair(rng: np.random.Generator, img, mask,
                             output_size: int,
                             scale: Tuple[float, float] = (0.8, 1.0),
                             ratio: Tuple[float, float] = (3 / 4, 4 / 3)):
    """RandomResizedCrop(output_size, (0.8, 1)): up to ten draws of area
    and aspect, else the centred square."""
    from PIL import Image
    w, h = img.size
    area = w * h
    for _ in range(10):
        target_area = area * rng.uniform(scale[0], scale[1])
        log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
        aspect = math.exp(rng.uniform(*log_ratio))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            left = int(rng.integers(0, w - cw + 1))
            top = int(rng.integers(0, h - ch + 1))
            box = (left, top, left + cw, top + ch)
            break
    else:
        side = min(w, h)
        left, top = (w - side) // 2, (h - side) // 2
        box = (left, top, left + side, top + side)
    size = (output_size, output_size)
    return (img.resize(size, Image.BICUBIC, box=box),
            mask.resize(size, Image.NEAREST, box=box))


def to_onehot_shuffled(rng: Optional[np.random.Generator], mask: np.ndarray,
                       max_obj_n: int,
                       obj_list: Optional[List[int]] = None
                       ) -> Tuple[np.ndarray, List[int]]:
    """Label mask -> one-hot [max_obj_n, H, W]: the objects (in a shuffled
    order drawn from ``rng``, or ``obj_list``'s) in slots 1.., the
    background ``1 - sum(objects)`` in slot 0."""
    oh = np.zeros((max_obj_n,) + mask.shape, np.float32)
    if obj_list is None:
        obj_list = [int(i) for i in np.unique(mask) if i != 0]
        if rng is not None:
            rng.shuffle(obj_list)
        obj_list = obj_list[:max_obj_n - 1]
    for slot, obj_id in enumerate(obj_list, start=1):
        oh[slot] = mask == obj_id
    oh[0] = 1.0 - np.clip(oh[1:].sum(axis=0), 0.0, 1.0)
    return oh, obj_list


class ClipAugmenter:
    """A ``clip_n``-frame pseudo-video from one annotated image (the
    reference's ``Water_Image_Train_DS``): frame 0 is the crop-resized
    original; later frames add flip, colour jitter and affine jitter.
    Returns (frames [clip_n, S, S, 3] float32 in [0, 1], one-hot masks
    [clip_n, max_obj_n, S, S], obj_n)."""

    def __init__(self, output_size: int, clip_n: int, max_obj_n: int):
        self.output_size = output_size
        self.clip_n = clip_n
        self.max_obj_n = max_obj_n

    def __call__(self, rng: np.random.Generator, img, mask
                 ) -> Tuple[np.ndarray, np.ndarray, int]:
        size = self.output_size
        frames = np.zeros((self.clip_n, size, size, 3), np.float32)
        masks = np.zeros((self.clip_n, self.max_obj_n, size, size),
                         np.float32)
        obj_list = None
        obj_n = 1
        for i in range(self.clip_n):
            im, mk = img, mask
            if i > 0:
                im, mk = random_hflip_pair(rng, im, mk)
                im = color_jitter(rng, im)
                im, mk = random_affine_pair(rng, im, mk)
            im, mk = random_resized_crop_pair(rng, im, mk, size)
            mk_np = np.array(mk, np.uint8)
            if i == 0:
                oh, obj_list = to_onehot_shuffled(rng, mk_np, self.max_obj_n)
                obj_n = len(obj_list) + 1
            else:
                oh, _ = to_onehot_shuffled(None, mk_np, self.max_obj_n,
                                           obj_list)
            frames[i] = np.asarray(im, np.float32) / 255.0
            masks[i] = oh
        return frames, masks, obj_n
