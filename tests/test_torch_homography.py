"""The port's homography ops against ``vfloodnet_tpu.ops.homography`` and
against the OpenCV calls the JAX package makes, on seeded inputs.

- ``find_homography`` and ``perspective_transform``: within 1e-9
  relative in float64; ``warp_perspective_nearest``: equal.
- The bilinear frame warp (``cv2.warpPerspective``, zero border, uint8):
  within 1 grey level of OpenCV on >= 99.9 % of pixels.
- The nearest mask warp (``INTER_NEAREST``): equal to OpenCV on >= 99.9 %
  of pixels.
- The tracker's window crop and its affine augmentations, which the JAX
  tracker makes with ``cv2.resize`` and ``cv2.warpAffine``
  (``BORDER_REFLECT``): the crop within 1e-3 of the patch's range. An
  OpenCV that rounds sample positions to 1/32 px (``INTER_BITS``, 4.x)
  may move a bilinear sample by up to 1/64 px along each axis, so by up to
  (|dI/dx| + |dI/dy|) / 64 for the patch's largest finite differences:
  the augmentations are held to that bound. Measured with OpenCV 5.0.0,
  which samples at the exact float position: at most 1.3e-3 grey levels
  apart on a 0-255 noise patch, against a bound of 7.9 grey levels there;
  the crop agrees within 1.3e-7 of the range.
"""

import cv2
import numpy as np
import pytest
import torch

from vfloodnet_tpu.ops import homography as jh
from vfloodnet_tpu.ops.tracker import MosseTracker as JTracker
from vfloodnet_tpu_torch.ops import homography as th
from vfloodnet_tpu_torch.ops.tracker import (SIZE, MosseTracker,
                                             rotation_matrix, warp_affine)


def _homography(rng, h, w, jitter):
    src = np.array([[10, 12], [w - 15, 8], [5, h - 9], [w - 3, h - 20]],
                   np.float64)
    dst = src + rng.uniform(-jitter, jitter, src.shape)
    return src, dst


def test_find_homography_and_transforms_match_jax():
    rng = np.random.default_rng(0)
    for n in (4, 9):
        src = rng.uniform(0, 500, (n, 2))
        dst = src + rng.uniform(-40, 40, (n, 2))
        want, got = jh.find_homography(src, dst), th.find_homography(src, dst)
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=0)
        pts = rng.uniform(0, 500, (50, 2))
        np.testing.assert_allclose(th.perspective_transform(pts, got),
                                   jh.perspective_transform(pts, want),
                                   rtol=1e-9, atol=0)
    with pytest.raises(ValueError):
        th.find_homography(src[:3], dst[:3])
    img = rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)
    hm = th.find_homography(*_homography(rng, 40, 56, 6))
    np.testing.assert_array_equal(th.warp_perspective_nearest(img, hm),
                                  jh.warp_perspective_nearest(img, hm))
    np.testing.assert_array_equal(
        th.warp_perspective_nearest(img, hm, (30, 70)),
        jh.warp_perspective_nearest(img, hm, (30, 70)))


@pytest.mark.parametrize("blur", [0.0, 1.5])
def test_frame_warp_matches_cv2(blur):
    rng = np.random.default_rng(1)
    h, w = 157, 213
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    if blur:
        img = cv2.GaussianBlur(img, (0, 0), blur)
    hm = th.find_homography(*_homography(rng, h, w, 14))
    want = cv2.warpPerspective(img, hm, (w, h))
    got = th.warp_perspective(torch.from_numpy(img), hm)
    assert got.dtype == torch.uint8 and got.shape == want.shape
    diff = np.abs(got.numpy().astype(int) - want.astype(int))
    assert (diff <= 1).mean() >= 0.999, diff.max()
    assert (want == 0).any()                    # the zero border is tested


def test_mask_warp_matches_cv2_nearest():
    rng = np.random.default_rng(2)
    h, w = 120, 160
    mask = (rng.random((h, w)) > 0.5).astype(np.uint8)
    mask[40:80] = 2
    for jitter in (3, 20):
        hm = th.find_homography(*_homography(rng, h, w, jitter))
        want = cv2.warpPerspective(mask, hm, (w, h), flags=cv2.INTER_NEAREST)
        got = th.warp_perspective_mask(torch.from_numpy(mask), hm).numpy()
        assert (got == want).mean() >= 0.999


def test_tracker_crop_and_augmentations_match_cv2():
    rng = np.random.default_rng(3)
    gray = rng.uniform(0, 255, (90, 120)).astype(np.float32)
    for bbox in ((40, 30, 30, 30), (-5, 60, 22, 17), (100, 2, 33, 40)):
        jt, tt = JTracker(), MosseTracker(device="cpu")
        for t in (jt, tt):
            x, y, w, h = bbox
            t._center, t._win = (x + w / 2, y + h / 2), (w * 2.0, h * 2.0)
        for scale in (1.0, 1 / 1.035, 1.035):
            want = jt._crop(gray, scale)
            got = tt._crop(torch.from_numpy(gray), scale).numpy()
            span = float(want.max() - want.min())
            assert np.abs(got - want).max() <= 1e-3 * span, bbox
    base = rng.uniform(0, 255, (SIZE, SIZE)).astype(np.float32)
    gx = np.abs(np.diff(base, axis=1)).max()
    gy = np.abs(np.diff(base, axis=0)).max()
    bound = (gx + gy) / 64
    for ang, scale in ((5.3, 1.02), (-7.9, 0.975), (0.4, 1.0)):
        m = rotation_matrix((SIZE / 2, SIZE / 2), ang, scale)
        np.testing.assert_allclose(
            m, cv2.getRotationMatrix2D((SIZE / 2, SIZE / 2), ang, scale),
            rtol=1e-12, atol=1e-12)
        want = cv2.warpAffine(base, m, (SIZE, SIZE),
                              borderMode=cv2.BORDER_REFLECT)
        got = warp_affine(torch.from_numpy(base), m, (SIZE, SIZE),
                          "reflect").numpy()
        assert np.abs(got - want).max() <= bound
