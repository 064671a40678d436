"""The port's overlays against ``vfloodnet_tpu.utils.palette`` and the
OpenCV marks the JAX package draws, on seeded inputs.

- ``add_overlay``: byte for byte equal, over labels 0-3, a custom alpha
  and colour scale.
- ``save_overlay``: the PNG decodes to the JAX package's, for uint8 and
  float images.
- The video runner with ``viz`` (its default, as in the JAX runner): one
  overlay per frame in ``<out>/<name>/overlay``, each equal to the JAX
  ``save_overlay`` of that frame and the mask the runner wrote.
- The reference boxes and waterline marks of ``est_by_reference``:
  equal to ``cv2.rectangle`` and ``cv2.line`` at thickness 2, clipped at
  the border.
"""

import os

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from vfloodnet_tpu.utils import palette as jpal
from vfloodnet_tpu_torch.models import AFBURR
from vfloodnet_tpu_torch.pipelines import reference_tracking as tref
from vfloodnet_tpu_torch.pipelines import run_video_segmentation
from vfloodnet_tpu_torch.utils import (add_overlay, load_image, load_mask,
                                       save_overlay, save_seg_mask)


def _image_and_mask(seed, h=45, w=67):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    mask = np.zeros((h, w), np.uint8)
    mask[h // 2:] = 1
    mask[5:15, 10:30] = 2
    mask[rng.random((h, w)) > 0.97] = 3
    return img, mask


@pytest.mark.parametrize("alpha,cscale", [(0.4, 1.0), (0.7, 0.5)])
def test_add_overlay_is_byte_equal(alpha, cscale):
    img, mask = _image_and_mask(0)
    want = jpal.add_overlay(img, mask, jpal.COLOR_PALETTE, alpha, cscale)
    got = add_overlay(img, mask, alpha=alpha, cscale=cscale)
    assert got.dtype == want.dtype == np.uint8
    assert got.tobytes() == want.tobytes()
    np.testing.assert_array_equal(add_overlay(img, np.zeros_like(mask)), img)


def test_save_overlay_png_matches_jax(tmp_path):
    img, mask = _image_and_mask(1)
    for name, frame in (("u8", img), ("float", img / 255.0)):
        jpal.save_overlay(frame, mask, str(tmp_path / f"jax_{name}.png"))
        save_overlay(frame, mask, str(tmp_path / f"port_{name}.png"))
        want = np.asarray(Image.open(tmp_path / f"jax_{name}.png"))
        got = np.asarray(Image.open(tmp_path / f"port_{name}.png"))
        np.testing.assert_array_equal(got, want)


def test_video_runner_viz_writes_jax_overlays(tmp_path):
    rng = np.random.RandomState(5)
    src = tmp_path / "frames"
    src.mkdir()
    for i in range(3):
        Image.fromarray((rng.rand(48, 64, 3) * 255).astype(np.uint8)).save(
            src / f"{i}.png")
    mask0 = np.zeros((48, 64), np.uint8)
    mask0[24:] = 1
    save_seg_mask(mask0, str(tmp_path / "mask0.png"))
    torch.manual_seed(0)
    out = run_video_segmentation(str(src), "clip", str(tmp_path / "out"),
                                 model=AFBURR().eval(), budget=1024,
                                 downsample=48,
                                 first_mask_path=str(tmp_path / "mask0.png"),
                                 device="cpu")
    overlay_dir = tmp_path / "out" / "clip" / "overlay"
    assert sorted(os.listdir(overlay_dir)) == ["0.png", "1.png", "2.png"]
    for name in ("0.png", "1.png", "2.png"):
        frame = load_image(str(src / name))
        mask = load_mask(os.path.join(out["mask_dir"], name))
        jpal.save_overlay(frame, mask, str(tmp_path / f"want_{name}"))
        np.testing.assert_array_equal(
            np.asarray(Image.open(overlay_dir / name)),
            np.asarray(Image.open(tmp_path / f"want_{name}")))


def test_box_and_waterline_marks_match_cv2():
    rng = np.random.default_rng(2)
    for _ in range(300):
        want = np.zeros((40, 50, 3), np.uint8)
        got = want.copy()
        x, y = (int(v) for v in rng.integers(-10, 55, 2))
        w, h = (int(v) for v in rng.integers(0, 30, 2))
        cv2.rectangle(want, (x, y), (x + w, y + h), tref.BOX_COLOR, 2)
        tref._rectangle(got, x, y, w, h, tref.BOX_COLOR)
        y1 = y + int(rng.integers(2, 30))
        cv2.line(want, (x, y), (x, y1), tref.LINE_COLOR, 2)
        tref._segment(got, (x, y), (x, y1), tref.LINE_COLOR)
        np.testing.assert_array_equal(got, want)
