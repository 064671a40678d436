"""The port's synthetic detection scenes, drawn without cv2, against the
JAX package's, which draws them with cv2 (OpenCV 5.0.0), on the CPU:

- ``render_stopsign_scene`` and ``render_person_scene`` give every array
  of the JAX package's scene bit for bit, over 50 seeds at 96 and 320 px,
  with and without a water band (the plate's rim is one pixel thick at
  96 px and up to 4 at 320 px);
- ``SyntheticStopsignDataset`` and ``SyntheticPeopleDataset`` samples
  equal the JAX package's over several epochs and indices;
- the drawing primitives of ``utils/draw.py`` equal cv2's on random
  shapes: ``fill_poly`` (convex and self-intersecting polygons),
  ``polylines`` (closed and open, 1 to 5 pixels thick), ``fill_rect``,
  ``fill_circle`` (radius 0 to 20) and one-pixel ``line``s.
"""

import cv2
import numpy as np
import pytest

from vfloodnet_tpu.data import detection_dataset as jdd
from vfloodnet_tpu_torch.data import detection_dataset as dd
from vfloodnet_tpu_torch.utils import draw


def _same_scene(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert np.asarray(g).dtype == np.asarray(w).dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("size", [96, 320])
def test_stopsign_scenes_match_jax(size):
    for seed in range(50):
        water = None if seed % 2 else 0.2 + 0.003 * seed
        _same_scene(
            dd.render_stopsign_scene(np.random.default_rng(seed), size,
                                     water_level=water),
            jdd.render_stopsign_scene(np.random.default_rng(seed), size,
                                      water_level=water))


@pytest.mark.parametrize("size", [96, 320])
def test_person_scenes_match_jax(size):
    for seed in range(50):
        water = None if seed % 2 else 0.15 + 0.003 * seed
        _same_scene(
            dd.render_person_scene(np.random.default_rng(seed), size,
                                   water_level=water),
            jdd.render_person_scene(np.random.default_rng(seed), size,
                                    water_level=water))


def test_datasets_match_jax():
    for name in ("SyntheticStopsignDataset", "SyntheticPeopleDataset"):
        got = getattr(dd, name)(n=16, size=96, seed=3)
        want = getattr(jdd, name)(n=16, size=96, seed=3)
        assert len(got) == len(want)
        for epoch, idx in ((0, 0), (0, 15), (2, 7)):
            for a, b in zip(got.get(idx, epoch), want.get(idx, epoch)):
                np.testing.assert_array_equal(a, b)


def test_drawing_primitives_match_cv2():
    rng = np.random.default_rng(0)
    for trial in range(400):
        s = 48
        shape = trial % 5
        a, b = np.zeros((s, s), np.uint8), np.zeros((s, s), np.uint8)
        if shape == 0:
            pts = rng.integers(2, s - 2, (int(rng.integers(3, 9)), 2))
            cv2.fillPoly(a, [pts.astype(np.int32)], 1)
            draw.fill_poly(b, pts, 1)
        elif shape == 1:
            pts = rng.integers(6, s - 6, (int(rng.integers(2, 8)), 2))
            closed, t = bool(trial % 2), int(rng.integers(1, 6))
            cv2.polylines(a, [pts.astype(np.int32)], closed, 1, t)
            draw.polylines(b, pts, closed, 1, t)
        elif shape == 2:
            p = rng.integers(0, s, 4)
            cv2.rectangle(a, (int(p[0]), int(p[1])), (int(p[2]), int(p[3])),
                          1, -1)
            draw.fill_rect(b, p[:2], p[2:], 1)
        elif shape == 3:
            r = int(rng.integers(0, 21))
            c = rng.integers(r, s - r, 2) if r < s // 2 else (s // 2,) * 2
            cv2.circle(a, (int(c[0]), int(c[1])), r, 1, -1)
            draw.fill_circle(b, c, r, 1)
        else:
            p = rng.integers(0, s, 4)
            cv2.line(a, (int(p[0]), int(p[1])), (int(p[2]), int(p[3])), 1)
            draw.line(b, p[:2], p[2:], 1)
        np.testing.assert_array_equal(b, a, err_msg=f"trial {trial}")
