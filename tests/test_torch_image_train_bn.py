"""The image trainer's step with live BatchNorm (``update_bn``) against
the JAX package's, on the CPU, and the LinkNet training form itself:

- the training form (``LinkNet(norm=TrainBN)``) in eval gives the serving
  form's probabilities bit for bit, and its ``state_dict`` exported to the
  JAX flat layout gives back every leaf of the bundled checkpoint exactly;
- one step of ``make_image_train_step(..., update_bn=True)`` at 64 px on
  a batch of 2 from the bundled checkpoint, both trainers in float64: the
  loss within 1e-9 relative, every gradient leaf within 1e-6 of its
  largest magnitude (a leaf that vanishes up to rounding, a bias feeding a
  live BN, within 1e-6 of 1e-9 of the largest leaf), and the new running
  statistics within 1e-6 relative.
"""

import os

import numpy as np
import pytest
import torch

from vfloodnet_tpu_torch.core.checkpoint import flatten, load_flat_npz
from vfloodnet_tpu_torch.core.convert import (convert_linknet_variables,
                                              export_linknet_variables)
from vfloodnet_tpu_torch.models import LinkNet, TrainBN

from torch_image_train_common import (check_leaves, check_loss,
                                      check_stats, image_batch,
                                      step_in_float64)

torch.set_num_threads(4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def trained():
    return load_flat_npz(os.path.join(REPO, "records", "checkpoints",
                                      "image", "best.npz"))


def test_training_form_evaluates_as_serving(trained):
    serving = LinkNet().eval()
    serving.load_state_dict(convert_linknet_variables(trained))
    train = LinkNet(norm=TrainBN).eval()
    train.load_state_dict(convert_linknet_variables(trained,
                                                    trainable_bn=True))
    images = torch.from_numpy(image_batch(hw=96)[0]).float()
    with torch.no_grad():
        assert torch.equal(serving(images), train(images))


def test_training_form_round_trips(trained):
    train = LinkNet(norm=TrainBN)
    train.load_state_dict(convert_linknet_variables(trained,
                                                    trainable_bn=True))
    back = export_linknet_variables(train.state_dict())
    want = flatten(trained)
    assert set(back) == set(want)
    for k, v in want.items():
        assert back[k].dtype == np.float32
        np.testing.assert_array_equal(back[k], v, err_msg=k)


@pytest.fixture(scope="module")
def step(trained):
    return step_in_float64(trained, update_bn=True)


def test_update_bn_loss_matches_jax_in_float64(step):
    check_loss(step)


def test_update_bn_gradients_match_jax_in_float64(step):
    check_leaves(step)


def test_update_bn_statistics_match_jax_in_float64(step):
    check_stats(step, update_bn=True)
