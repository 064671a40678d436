"""One AFB-URR training step of the port against the JAX trainer in
float32, on the CPU, with the bundled trained checkpoint carried into the
port's training form, on two seeded clips of 3 frames of 32 x 32 and 2
objects (a smooth sky-over-water scene each):

- ``video_clip_loss``: the loss within 1e-5 relative of JAX's, with frozen
  BN and with ``update_bn``, where the BNs' new running statistics agree
  within 1e-5; the gradient, as one vector, points where JAX's
  ``value_and_grad`` points (cosine >= 1 - 1e-6);
- ``remat`` gives the plain step's loss and gradients exactly;
- the optimiser against ``optax.chain(clip_by_global_norm, adamw(
  schedule))`` of the JAX ``init_video_train_state`` on fixed synthetic
  gradients over 6 steps that cross two boundaries of the schedule, some
  clipped and some not: parameters within 1e-6 relative; the schedule
  equal to ``make_lr_schedule``'s at every count.

Each gradient leaf against JAX's is held in float64, on the JAX random
init (``tests/test_torch_train_grads.py``). In float32 it cannot be held
leaf by leaf on these shapes: the float64 gradient itself moves by up to
8e-4 of a leaf's largest magnitude when the frames move by 1e-7, so both
frameworks' float32 leaves stray from their own float64 ones by up to
1e-2 (and, with live BatchNorm over 8 values a channel at 1/16 on the
random init, by up to 0.4).
"""

import dataclasses
import os

import jax
import numpy as np
import optax
import pytest
import torch

from vfloodnet_tpu.train import train_video as jtv
from vfloodnet_tpu_torch.core.checkpoint import flatten, load_flat_npz
from vfloodnet_tpu_torch.train import train_video as tv

from torch_train_common import (jax_loss_and_grads, make_clips,
                                port_loss_and_grads, port_model)

torch.set_num_threads(4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def trained():
    return load_flat_npz(os.path.join(REPO, "records", "checkpoints",
                                      "video", "best.npz"))


def _params_vector(flat):
    return np.concatenate([np.asarray(flat[k], np.float64).ravel()
                           for k in sorted(flat) if k.startswith("params/")])


@pytest.mark.parametrize("update_bn", [False, True],
                         ids=["frozen_bn", "update_bn"])
def test_loss_and_stats_match_jax(trained, update_bn):
    frames, masks = make_clips()
    want_loss, want = jax_loss_and_grads(trained, frames, masks, update_bn)
    got_loss, got = port_loss_and_grads(port_model(trained), frames, masks,
                                        update_bn)
    assert np.isfinite(want_loss)
    assert abs(got_loss - want_loss) <= 1e-5 * abs(want_loss)
    if update_bn:
        assert set(got) == set(want)
    else:
        assert set(got) == {k for k in want if k.startswith("params/")}
    g, w = _params_vector(got), _params_vector(want)
    assert g @ w >= (1 - 1e-6) * np.linalg.norm(g) * np.linalg.norm(w)
    if update_bn:
        before = flatten(trained)
        for k, s in want.items():
            if k.startswith("batch_stats/"):
                np.testing.assert_allclose(got[k], s, rtol=0, atol=1e-5,
                                           err_msg=k)
                assert not np.array_equal(s, before[k]), k   # it ran


def test_remat_equals_plain(trained):
    frames, masks = make_clips(seed=1)
    model = port_model(trained)
    for update_bn in (False, True):
        plain = port_loss_and_grads(model, frames, masks, update_bn)
        remat = port_loss_and_grads(model, frames, masks, update_bn,
                                    remat=True)
        assert remat[0] == plain[0]
        for k, g in plain[1].items():
            np.testing.assert_array_equal(remat[1][k], g, err_msg=k)


def test_optimizer_and_schedule_match_optax():
    cfg = tv.VideoTrainConfig(lr=1e-2, epochs=4, scheduler_step_epochs=1,
                              grad_clip=1.0)
    jcfg = jtv.VideoTrainConfig(**dataclasses.asdict(cfg))
    spe = 2
    rng = np.random.default_rng(0)
    params = {"a/kernel": rng.standard_normal((3, 3, 4, 5), np.float32),
              "b/bias": rng.standard_normal((7,), np.float32)}
    _, tx = jtv.init_video_train_state(None, {"params": params,
                                              "batch_stats": {}}, jcfg, spe)
    jparams = dict(params)
    opt_state = tx.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in params.items()}
    opt = tv.AdamWClip(tparams, tv.make_lr_schedule(cfg, spe),
                       cfg.weight_decay, cfg.grad_clip)
    sched = tv.make_lr_schedule(cfg, spe)
    jsched = jtv.make_lr_schedule(jcfg, spe)
    for count in range(12):
        assert np.float32(sched(count)) == np.float32(jsched(count)), count
    for step, scale in enumerate((3.0, 0.01, 5.0, 0.02, 0.5, 4.0)):
        grads = {k: scale * rng.standard_normal(v.shape, np.float32)
                 / np.float32(np.sqrt(v.size)) for k, v in params.items()}
        updates, opt_state = tx.update(grads, opt_state, jparams)
        jparams = jax.tree.map(np.asarray,
                               optax.apply_updates(jparams, updates))
        opt.step({k: torch.from_numpy(g) for k, g in grads.items()})
        for k in params:
            np.testing.assert_allclose(tparams[k].detach().numpy(),
                                       jparams[k], rtol=1e-6, atol=0,
                                       err_msg=f"{k} at step {step}")
    assert opt.count == 6
