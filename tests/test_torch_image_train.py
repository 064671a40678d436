"""The port's image trainer against the JAX package's, on the CPU:

- ``random_mask_perturbation`` and ``WaterImageDataset`` (on
  ``records/demo_train``, several seeds, epochs and samples, with and
  without ``perturb_masks``) give the JAX package's arrays bit for bit;
- ``dice_loss`` and ``iou_metric`` within 1e-6 of JAX's on random
  predictions;
- one step of ``make_image_train_step`` with frozen BN (the step with
  ``update_bn`` is ``tests/test_torch_image_train_bn.py``'s), at 64 px on
  a batch of 2, from the bundled trained checkpoint carried into the
  training form, both trainers in float64 (``jnp.float32`` pointed at
  float64 for JAX's call): the loss within 1e-9 relative, every gradient
  leaf within 1e-6 of its largest magnitude (the export to the Flax
  layout rounds to float32);
- the optimiser against ``optax.adam(piecewise_constant_schedule)`` of the
  JAX ``init_image_train_state`` over 6 steps that cross the schedule's
  boundary: parameters within 1e-6 relative.

XLA's float64 convolutions on the CPU are slow: JAX's step takes about
35 s of the file's time.
"""

import os

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vfloodnet_tpu.data import WaterImageDataset as JDataset
from vfloodnet_tpu.data.transforms import \
    random_mask_perturbation as j_perturb
from vfloodnet_tpu.train import train_image as jti
from vfloodnet_tpu_torch.core.checkpoint import load_flat_npz
from vfloodnet_tpu_torch.data import WaterImageDataset
from vfloodnet_tpu_torch.data.transforms import random_mask_perturbation
from vfloodnet_tpu_torch.train import train_image as ti

from torch_image_train_common import (check_leaves, check_loss,
                                      check_stats, step_in_float64)

torch.set_num_threads(4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_mask_perturbation_matches_jax():
    rng = np.random.default_rng(0)
    for seed in range(8):
        m = (rng.random((40, 50)) > 0.6).astype(np.float32)
        np.testing.assert_array_equal(
            random_mask_perturbation(np.random.default_rng(seed), m),
            j_perturb(np.random.default_rng(seed), m))


def test_dataset_matches_jax():
    root = os.path.join(REPO, "records", "demo_train")
    for perturb, seed, epoch in ((False, 0, 0), (False, 3, 1), (True, 3, 1),
                                 (True, 7, 5)):
        got = WaterImageDataset("train_offline", root, input_size=96,
                                seed=seed, perturb_masks=perturb)
        want = JDataset("train_offline", root, input_size=96, seed=seed,
                        perturb_masks=perturb)
        assert len(got) == len(want) > 0
        for idx in range(min(len(got), 3)):
            for a, b in zip(got.get(idx, epoch), want.get(idx, epoch)):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


def test_dice_and_iou_match_jax():
    rng = np.random.default_rng(1)
    pred = rng.random((3, 20, 24)).astype(np.float32)
    target = (rng.random((3, 20, 24)) > 0.5).astype(np.float32)
    for fn in ("dice_loss", "iou_metric"):
        got = float(getattr(ti, fn)(torch.from_numpy(pred),
                                    torch.from_numpy(target)))
        want = float(getattr(jti, fn)(jnp.asarray(pred), jnp.asarray(target)))
        assert abs(got - want) <= 1e-6 * abs(want), fn


@pytest.fixture(scope="module")
def step():
    return step_in_float64(load_flat_npz(os.path.join(
        REPO, "records", "checkpoints", "image", "best.npz")),
        update_bn=False)


def test_frozen_bn_loss_matches_jax_in_float64(step):
    check_loss(step)


def test_frozen_bn_gradients_and_statistics_match_jax_in_float64(step):
    check_leaves(step)
    check_stats(step, update_bn=False)


def test_optimiser_matches_optax_adam_schedule():
    rng = np.random.default_rng(2)
    shapes = {"a": (3, 4), "b": (5,)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    cfg = ti.ImageTrainConfig(epochs=4)      # the boundary at step 2 x 3
    steps_per_epoch = 3
    state, tx = jti.init_image_train_state(
        None, {"params": params, "batch_stats": {}}, cfg, steps_per_epoch)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = ti.AdamWClip(tp, ti.make_image_lr_schedule(cfg, steps_per_epoch),
                       weight_decay=0.0)
    jp, jo = state.params, state.opt_state
    for i in range(6):
        g = {k: (rng.standard_normal(s) * 10 ** (i - 3)).astype(np.float32)
             for k, s in shapes.items()}
        upd, jo = tx.update(g, jo, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step({k: torch.from_numpy(v) for k, v in g.items()})
        for k in shapes:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=f"{k} step {i}")
