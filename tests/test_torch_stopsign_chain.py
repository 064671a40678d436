"""The trained stop-sign chain through the port against the JAX package on
the CPU: the tiny detector trained on synthetic scenes
(``records/checkpoints/stopsign_tiny/best.npz`` with its
``rcnn_config.json``) on the two committed scenes
(``records/demo_eval/stopsign``).

- Detections: the same count and classes, boxes within 0.5 px, scores
  within 1e-3, each mask's IoU with JAX's >= 0.98.
- ``waterdepth.txt``: the JAX package's rows as written (scene0 0.7357 /
  158.8342, scene1 0.2500 / 53.9842).
- The three canvases of each scene: >= 0.99 of pixels equal.
- The CLIs: ``python -m vfloodnet_tpu_torch.pipelines.waterlevel --opt
  stopsign --device cpu`` writes the rows ``est_waterlevel.py --opt
  stopsign`` writes.
"""

import os
import shutil
import subprocess
import sys
from glob import glob

import numpy as np
import pytest

from vfloodnet_tpu.pipelines import object_detection as jod
from vfloodnet_tpu.models.detection import load_default_detector as jload
from vfloodnet_tpu_torch.models.detection import load_default_detector
from vfloodnet_tpu_torch.pipelines import object_detection as tod
from vfloodnet_tpu_torch.utils import load_image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = os.path.join(REPO, "records", "demo_eval", "stopsign")
ROWS = ["scene0\t0.7357\t158.8342", "scene1\t0.2500\t53.9842"]


def _lists():
    imgs = sorted(glob(os.path.join(SCENES, "frames", "*.png")))
    return imgs, [os.path.join(SCENES, "masks", os.path.basename(p))
                  for p in imgs]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    imgs, masks = _lists()
    out = {}
    for name, fn in (("jax", jod.est_by_obj_detection),
                     ("port", tod.est_by_obj_detection)):
        d = str(tmp_path_factory.mktemp(name))
        kw = {"device": "cpu"} if name == "port" else {}
        with open(fn(imgs, masks, d, "stopsign", **kw)) as f:
            out[name] = (d, f.read().splitlines())
    return out


def test_instances_match_jax():
    jdet = jload("stopsign")
    tdet = load_default_detector("stopsign", device="cpu")
    for path in _lists()[0]:
        img = np.ascontiguousarray(load_image(path)[..., ::-1])
        want, got = jdet(img), tdet(img)
        assert len(got) == len(want) > 0
        np.testing.assert_array_equal(got.classes, want.classes)
        np.testing.assert_allclose(got.boxes, want.boxes, atol=0.5, rtol=0)
        np.testing.assert_allclose(got.scores, want.scores, atol=1e-3,
                                   rtol=0)
        for g, w in zip(got.masks.astype(bool), want.masks.astype(bool)):
            assert (g & w).sum() / max((g | w).sum(), 1) >= 0.98


def test_waterdepth_rows_match_jax(runs):
    assert runs["jax"][1] == ROWS
    assert runs["port"][1] == ROWS


def test_canvases_match_jax(runs):
    import cv2
    for scene in ("scene0", "scene1"):
        for kind in ("pred", "template", "est"):
            want = cv2.imread(os.path.join(runs["jax"][0], "result",
                                           f"{scene}_{kind}.png"))
            got = cv2.imread(os.path.join(runs["port"][0], "result",
                                          f"{scene}_{kind}.png"))
            assert got is not None and got.shape == want.shape
            assert (got == want).all(axis=-1).mean() >= 0.99


def test_cli_matches_est_waterlevel(tmp_path):
    frames = tmp_path / "frames"
    seg = tmp_path / "segs" / "demo" / "mask"
    frames.mkdir()
    seg.mkdir(parents=True)
    for img, mask in zip(*_lists()):
        shutil.copy(img, frames)
        shutil.copy(mask, seg)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    rows = {}
    for name, cmd in (
            ("jax", [sys.executable, "est_waterlevel.py"]),
            ("port", [sys.executable, "-m",
                      "vfloodnet_tpu_torch.pipelines.waterlevel",
                      "--device", "cpu"])):
        out = tmp_path / name
        subprocess.run(cmd + ["--test-path", str(frames), "--test-name",
                              "demo", "--opt", "stopsign", "--seg-dir",
                              str(tmp_path / "segs"), "--out-dir", str(out)],
                       cwd=REPO, env=env, check=True, capture_output=True,
                       timeout=300)
        with open(out / "demo_stopsign" / "waterdepth.txt") as f:
            rows[name] = f.read().splitlines()
    assert rows["port"] == rows["jax"] == ROWS
