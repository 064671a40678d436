"""The stop-sign geometry of the port without cv2, against the JAX package
(which calls cv2) and cv2 itself, on the CPU, on numpy-seeded inputs.

- ``fit_octagon`` on 240 masks (octagons under random homographies, some
  cut by the border, blobs, rings with holes and something inside them,
  several components, noise): the same ``None`` or the same vertices.
- The four contour calls against cv2's on 200 masks: the same contours
  in the same order, areas and lengths equal, the same polygons at three
  epsilons.
- Detectron2's resize (OpenCV's uint8 ``INTER_LINEAR``) against cv2 on
  random sizes: within 1 grey level; the exact share is 1.0 on OpenCV
  5.0.0 (the vertical pass is OpenCV's SIMD fixed point).
- ``paste_mask`` against the JAX package's: >= 0.999 of pixels (OpenCV's
  float resize rounds in another order, about 1e-6 apart).
- ``cv2.line`` at the canvases' thickness (6) inside the image: equal.
- The pole march and the template against the JAX package's: equal.
"""

import cv2
import numpy as np
import pytest
import torch

from vfloodnet_tpu.models.detection.meta import paste_mask as jax_paste
from vfloodnet_tpu.models.detection.meta import \
    preprocess_bgr as jax_preprocess
from vfloodnet_tpu.pipelines import object_detection as jod
from vfloodnet_tpu_torch.models.detection.meta import (paste_mask,
                                                       preprocess_bgr)
from vfloodnet_tpu_torch.ops import contour
from vfloodnet_tpu_torch.ops.resize import cv2_linear_u8
from vfloodnet_tpu_torch.pipelines import object_detection as tod
from vfloodnet_tpu_torch.utils.draw import line


def _octagon_mask(rng, h, w):
    plate, _, _ = jod.make_stopsign_template()
    s = rng.uniform(0.4, 2.5)
    hmat = np.array([[s * rng.uniform(0.8, 1.2), rng.uniform(-0.3, 0.3),
                      rng.uniform(-100, w)],
                     [rng.uniform(-0.3, 0.3), s * rng.uniform(0.8, 1.2),
                      rng.uniform(-80, h)],
                     [rng.uniform(-1e-3, 1e-3), rng.uniform(-1e-3, 1e-3),
                      1.0]])
    pts = jod.perspective_transform(plate, hmat)
    m = np.zeros((h, w), np.uint8)
    cv2.fillPoly(m, [np.round(pts).astype(np.int32)], 1)
    return m


def _masks(n, seed):
    rng = np.random.RandomState(seed)
    for t in range(n):
        h, w = rng.randint(40, 260, 2)
        kind = t % 6
        if kind in (0, 1):
            m = _octagon_mask(rng, h, w)
        elif kind == 2:
            m = np.zeros((h, w), np.uint8)
            for _ in range(rng.randint(1, 5)):
                cv2.ellipse(m, (int(rng.randint(0, w)), int(rng.randint(0, h))),
                            (int(rng.randint(2, 60)), int(rng.randint(2, 60))),
                            float(rng.uniform(0, 180)), 0, 360, 1, -1)
        elif kind == 3:
            m = np.zeros((h, w), np.uint8)
            c = (w // 2, h // 2)
            cv2.circle(m, c, int(min(h, w) * 0.45), 1, -1)
            cv2.circle(m, c, int(min(h, w) * 0.3), 0, -1)
            cv2.circle(m, c, int(min(h, w) * 0.1), 1, -1)
        elif kind == 4:
            m = _octagon_mask(rng, h, w) | _octagon_mask(rng, h, w)
        else:
            m = (cv2.GaussianBlur(rng.rand(h, w), (0, 0), 3) > 0.5).astype(
                np.uint8)
        yield m


def test_fit_octagon_matches_jax():
    found = 0
    for m in _masks(240, 0):
        want = jod.fit_octagon(m)
        got = tod.fit_octagon(m)
        assert (want is None) == (got is None)
        if want is not None:
            found += 1
            np.testing.assert_array_equal(got, want)
    assert found >= 60


def test_contour_calls_match_cv2():
    for m in _masks(200, 1):
        want, _ = cv2.findContours(m.copy(), cv2.RETR_EXTERNAL,
                                   cv2.CHAIN_APPROX_SIMPLE)
        got = contour.find_external_contours(m)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
            assert contour.contour_area(g) == cv2.contourArea(w)
            peri = cv2.arcLength(w, True)
            assert contour.arc_length(g) == peri
            for f in (0.005, 0.02, 0.1):
                np.testing.assert_array_equal(
                    contour.approx_poly_dp(g, f * peri),
                    cv2.approxPolyDP(w, f * peri, True))


def test_resize_u8_matches_cv2():
    rng = np.random.RandomState(2)
    exact = total = 0
    for t in range(40):
        h, w = rng.randint(2, 300, 2)
        oh, ow = rng.randint(1, 400, 2)
        img = rng.randint(0, 256, (h, w, 3) if t % 2 else (h, w)).astype(
            np.uint8)
        want = cv2.resize(img, (int(ow), int(oh)))
        got = cv2_linear_u8(torch.from_numpy(img), (oh, ow)).numpy()
        d = np.abs(got.astype(int) - want.astype(int))
        assert d.max() <= 1
        exact += (d == 0).sum()
        total += d.size
    frame = rng.randint(0, 256, (1080, 1920, 3)).astype(np.uint8)
    want, w_scale = jax_preprocess(frame, 800, 1333)
    got, g_scale = preprocess_bgr(frame, 800, 1333)
    assert g_scale == w_scale and got.shape == want.shape == (768, 1344, 3)
    d = np.abs(got.numpy() - want)
    assert d.max() <= 1
    exact += (d == 0).sum()
    total += d.size
    print(f"exact share {exact / total:.6f}")
    assert exact / total == 1.0


def test_paste_mask_matches_jax():
    rng = np.random.RandomState(3)
    agree = total = 0
    for t in range(60):
        m = int(rng.choice([7, 28, 56]))
        logit = (rng.randn(m, m) * 3).astype(np.float32)
        x1, y1 = rng.uniform(-20, 200, 2)
        box = np.array([x1, y1, x1 + rng.uniform(1, 150),
                        y1 + rng.uniform(1, 150)], np.float32)
        want = jax_paste(logit, box, (240, 320))
        got = paste_mask(logit, box, (240, 320))
        agree += (got == want).sum()
        total += got.size
    assert agree / total >= 0.999


def test_draw_line_matches_cv2():
    rng = np.random.RandomState(4)
    for _ in range(150):
        a = np.full((160, 200, 3), 255, np.uint8)
        b = a.copy()
        p0 = tuple(int(v) for v in rng.randint(8, 150, 2))
        p1 = tuple(int(v) for v in rng.randint(8, 150, 2))
        cv2.line(a, p0, p1, (0, 200, 0), 6)
        line(b, p0, p1, (0, 200, 0), 6)
        np.testing.assert_array_equal(b, a)


def test_march_and_template_match_jax():
    for want, got in zip(jod.make_stopsign_template(),
                         tod.make_stopsign_template()):
        np.testing.assert_array_equal(got, want)
    rng = np.random.RandomState(5)
    for _ in range(100):
        water = np.zeros((240, 320), np.uint8)
        water[int(rng.randint(0, 240)):] = 1
        top = rng.uniform(-20, 300, 2)
        bottom = top + rng.uniform(-50, 250, 2)
        w_hit, w_ratio = jod.march_pole_to_water(top, bottom, water)
        g_hit, g_ratio = tod.march_pole_to_water(top, bottom, water)
        np.testing.assert_array_equal(g_hit, w_hit)
        assert g_ratio == w_ratio
