"""The port's detection trainer against the JAX package's, on the CPU,
with the bundled trained tiny people detector (masks and keypoints) at
64 px, 16 ROIs of which the top 6 anchors, 2 of them through the keypoint
head, and JAX's random proposals passed in:

- ``pairwise_iou``, ``encode_boxes``, ``level_anchors`` and both target
  assignments equal JAX's on boxes with ties (an anchor equally close to
  two GTs, GTs that share a best anchor, an invalid GT slot);
- ``detection_loss`` and each of its terms within 1e-5 relative in
  float32, for the stop-sign config (masks) and the people config (masks
  and keypoints).

The gradients (in float64) and the weight files are held in
``tests/test_torch_detection_grads.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfloodnet_tpu.train import train_detection as jtd
from vfloodnet_tpu_torch.train import train_detection as td

from torch_detection_train_common import (S, for_config, jax_loss_and_grads,
                                          port_loss_and_grads, port_model,
                                          scene, trained_people)

torch.set_num_threads(4)


@pytest.fixture(scope="module")
def init():
    return trained_people()


def _boxes():
    """GTs with ties (an anchor equally close to two GTs, a GT twice, a
    small GT that reaches no positive IoU, invalid slots) and ROIs."""
    gt = np.zeros((8, 4), np.float32)
    gt[0] = [8, 8, 40, 40]
    gt[1] = [24, 8, 56, 40]
    gt[2] = [8, 8, 40, 40]
    gt[3] = [2, 50, 6, 54]
    valid = np.array([1, 1, 1, 1, 0, 0, 0, 0], np.float32)
    classes = np.array([11, 0, 5, 1, 0, 0, 0, 0], np.int32)
    rois = np.concatenate([gt, [[8, 8, 40, 40], [16, 8, 48, 40],
                                [0, 0, 64, 64], [30, 30, 31, 31]]]).astype(
        np.float32)
    return gt, valid, classes, rois


def test_box_ops_and_anchors_match_jax():
    anchors = np.asarray(jtd.level_anchors(S))
    np.testing.assert_array_equal(td.level_anchors(S).numpy(), anchors)
    gt, _, _, rois = _boxes()
    t = torch.from_numpy
    np.testing.assert_allclose(
        td.pairwise_iou(t(rois), t(gt)).numpy(),
        np.asarray(jtd.pairwise_iou(jnp.asarray(rois), jnp.asarray(gt))),
        rtol=1e-6, atol=0)
    np.testing.assert_allclose(
        td.encode_boxes(t(gt[:4]), t(rois[:4] + 1)).numpy(),
        np.asarray(jtd.encode_boxes(jnp.asarray(gt[:4]),
                                    jnp.asarray(rois[:4] + 1))),
        rtol=1e-6, atol=1e-7)


def test_rpn_and_roi_targets_match_jax():
    gt, valid, classes, rois = _boxes()
    anchors = td.level_anchors(S)
    t = torch.from_numpy
    want = jtd.assign_rpn_targets(jnp.asarray(anchors.numpy()),
                                  jnp.asarray(gt), jnp.asarray(valid), 0.7,
                                  0.3)
    got = td.assign_rpn_targets(anchors, t(gt), t(valid), 0.7, 0.3)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert (got[0] == 1).sum() >= 3
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-6, atol=1e-6)
    want = jtd.assign_roi_targets(jnp.asarray(rois), jnp.asarray(gt),
                                  jnp.asarray(classes), jnp.asarray(valid),
                                  80, 0.5)
    got = td.assign_roi_targets(t(rois), t(gt), t(classes), t(valid), 80,
                                0.5)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]),
                               rtol=1e-6, atol=1e-5)


@pytest.fixture(scope="module", params=[False, True],
                ids=["stopsign", "people"])
def losses(request, init):
    """(people, JAX's loss and terms, the port's) in float32."""
    people = request.param
    variables = for_config(init, people)
    sample = scene(people)
    want_loss, want_aux, _, rand = jax_loss_and_grads(
        variables, people, sample, grads=False)
    got_loss, got_aux, _ = port_loss_and_grads(
        port_model(variables, people), sample, rand)
    return people, want_loss, want_aux, got_loss, got_aux


def test_loss_matches_jax_in_float32(losses):
    _, want_loss, _, got_loss, _ = losses
    assert np.isfinite(want_loss)
    assert abs(got_loss - want_loss) <= 1e-5 * abs(want_loss)


def test_loss_terms_match_jax_in_float32(losses):
    people, _, want_aux, _, got_aux = losses
    assert set(got_aux) == set(want_aux)
    assert ("kp" in want_aux) == people and "mask" in want_aux
    for k, w in want_aux.items():
        assert abs(got_aux[k] - w) <= 1e-5 * abs(w) + 1e-7, k
