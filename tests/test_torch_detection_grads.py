"""The port's detection trainer in float64 against the JAX package's, and
its weight files, on the CPU, with the bundled trained tiny people
detector at 64 px:

- one ``detection_loss`` with masks and keypoints, both trainers in
  float64 (``jnp.float32`` pointed at float64 for JAX's call), JAX's
  random proposals passed in: the loss within 1e-9 relative, every
  gradient leaf within 1e-6 of its largest magnitude (the export to the
  Flax layout rounds to float32; a leaf whose gradient vanishes, rounding
  noise near 1e-17 in both, within 1e-6 of 1e-9 of the largest leaf),
  the backbone, FPN and RPN leaves and the ROI heads' as two cases;
- ``convert_rcnn_variables(..., trainable_bn=True)`` and
  ``export_rcnn_variables`` round-trip every leaf exactly, and a
  ``best.npz`` and ``rcnn_config.json`` written as the trainer writes
  them load through both packages' ``load_default_detector``, which then
  detect the same boxes on a rendered scene.

JAX's float64 step on the CPU takes most of the file's time (~45 s of
~65 s serially).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfloodnet_tpu.models.detection.meta import \
    load_default_detector as j_load_detector
from vfloodnet_tpu_torch.core.checkpoint import flatten, save_flat_npz
from vfloodnet_tpu_torch.core.convert import export_rcnn_variables
from vfloodnet_tpu_torch.models.detection.meta import load_default_detector
from vfloodnet_tpu_torch.train import train_detection as td

from torch_detection_train_common import (S, jax_loss_and_grads,
                                          port_loss_and_grads, port_model,
                                          scene, trained_people)
from torch_image_train_common import NOISE_FLOOR
from torch_train_common import jax_float64

torch.set_num_threads(4)


@pytest.fixture(scope="module")
def init():
    return trained_people()


@pytest.fixture(scope="module")
def step():
    """Both packages' loss and gradients in float64 from the trained tiny
    people detector."""
    v64 = jax.tree.map(lambda a: np.asarray(a, np.float64),
                       trained_people())
    sample = [np.asarray(a, np.float64) if a.dtype == np.float32 else a
              for a in scene(True)]
    with jax_float64():
        want_loss, _, want, rand = jax_loss_and_grads(
            v64, True, sample, dtype=jnp.float64)
    got_loss, _, got = port_loss_and_grads(
        port_model(v64, True, torch.float64), sample, rand)
    return got_loss, want_loss, got, want


def test_loss_matches_jax_in_float64(step):
    got_loss, want_loss, _, _ = step
    assert np.isfinite(want_loss)
    assert abs(got_loss - want_loss) <= 1e-9 * abs(want_loss)


@pytest.mark.parametrize("part", [
    ("backbone/", "fpn/", "rpn/"),
    ("box_head/", "mask_head/", "keypoint_head/")],
    ids=["backbone_fpn_rpn", "roi_heads"])
def test_grads_match_jax_in_float64(step, part):
    _, _, got, want = step
    assert set(got) == set(want)
    top = max(np.abs(w).max() for w in want.values())
    keys = [k for k in want if k[len("params/"):].startswith(part)]
    assert keys
    for k in keys:
        w = want[k]
        scale = max(np.abs(w).max(), NOISE_FLOOR * top)
        assert np.abs(got[k] - w).max() <= 1e-6 * scale, k


def test_weights_round_trip(init):
    back = export_rcnn_variables(port_model(init, True).state_dict())
    want = flatten(init)
    assert set(back) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_weight_files_load_in_both_packages(init, tmp_path):
    path = str(tmp_path / "best.npz")
    save_flat_npz(path, export_rcnn_variables(
        port_model(init, True).state_dict()))
    with open(tmp_path / "rcnn_config.json", "w") as f:
        json.dump(dataclasses.asdict(td.tiny_people_config(S)), f)
    img = (scene(True, seed=8)[0]).astype(np.uint8)
    got = load_default_detector("people", model_path=path, device="cpu")(img)
    ref = j_load_detector("people", model_path=path)(img)
    assert got.boxes.shape == ref.boxes.shape
    np.testing.assert_allclose(got.boxes, ref.boxes, rtol=0, atol=1e-2)
