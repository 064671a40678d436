"""The port's training form and its gradients against the JAX trainer's,
on the CPU, with the JAX package's random init at 32 x 32 (one module
fixture), carried into the port by the weight bridge:

- the training form in eval equals the serving form (BatchNorm folded)
  bit for bit, and its ``state_dict`` exported to the JAX flat layout
  gives back every Flax leaf exactly;
- one step's loss, every gradient leaf and, with ``update_bn``, the new
  running statistics, both trainers in float64, on two seeded clips of 3
  frames and 2 objects: the loss within 1e-9 relative, each gradient leaf
  within 1e-6 of its largest magnitude, statistics within 1e-6 relative
  (the export to the Flax layout rounds both to float32). The JAX
  modules cast to ``jnp.float32`` by name; the test points that name at
  float64, with x64 on, for the duration of JAX's call, and the port's
  training form keeps float64 where it would cast to float32. In float32
  the gradient of these shapes is too ill-conditioned to compare leaf by
  leaf (see ``tests/test_torch_train_step.py``).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfloodnet_tpu.models import AFBURR as JAFBURR
from vfloodnet_tpu_torch.core import convert_afb_urr_variables
from vfloodnet_tpu_torch.core.checkpoint import flatten
from vfloodnet_tpu_torch.core.convert import export_afb_urr_variables
from vfloodnet_tpu_torch.models import AFBURR

from torch_train_common import (jax_loss_and_grads, make_clips,
                                   port_loss_and_grads, port_model)

torch.set_num_threads(4)


@pytest.fixture(scope="module")
def init():
    jm = JAFBURR()
    variables = jax.jit(lambda k: jm.init(
        k, jnp.zeros((32, 32, 3)), jnp.zeros((2, 32, 32)),
        method=jm.init_all))(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, variables)


@contextlib.contextmanager
def jax_float64():
    """x64 on, and ``jnp.float32`` naming float64, inside the block."""
    saved = jnp.float32
    jax.config.update("jax_enable_x64", True)
    jnp.float32 = jnp.float64
    try:
        yield
    finally:
        jnp.float32 = saved
        jax.config.update("jax_enable_x64", False)


def test_training_form_evaluates_as_serving_and_round_trips(init):
    serving = AFBURR().eval()
    serving.load_state_dict(convert_afb_urr_variables(init))
    train = port_model(init).eval()
    frames, masks = make_clips(b=1)
    with torch.no_grad():
        k_s, v_s = serving.memorize(torch.from_numpy(frames[0, 0]),
                                    torch.from_numpy(masks[0, 0]))
        k_t, v_t = train.memorize(torch.from_numpy(frames[0, 0]),
                                  torch.from_numpy(masks[0, 0]))
        valid = torch.ones(k_s.shape[:2], dtype=torch.bool)
        s_s, _ = serving.segment(torch.from_numpy(frames[0, 1:]), k_s, v_s,
                                 valid)
        s_t, _ = train.segment(torch.from_numpy(frames[0, 1:]), k_t, v_t,
                               valid)
    for a, b in ((k_s, k_t), (v_s, v_t), (s_s, s_t)):
        assert torch.equal(a, b)
    back = export_afb_urr_variables(train.state_dict())
    want = flatten(init)
    assert set(back) == set(want)
    for k, v in want.items():
        assert back[k].dtype == np.float32
        np.testing.assert_array_equal(back[k], v, err_msg=k)


@pytest.mark.parametrize("update_bn", [False, True],
                         ids=["frozen_bn", "update_bn"])
def test_grads_and_stats_match_jax_in_float64(init, update_bn):
    frames, masks = make_clips()
    v64 = jax.tree.map(lambda a: np.asarray(a, np.float64), init)
    with jax_float64():
        want_loss, want = jax_loss_and_grads(
            v64, frames.astype(np.float64), masks.astype(np.float64),
            update_bn, dtype=jnp.float64)
    model = port_model(v64, dtype=torch.float64)
    got_loss, got = port_loss_and_grads(model, frames, masks, update_bn)
    assert np.isfinite(want_loss)
    assert abs(got_loss - want_loss) <= 1e-9 * abs(want_loss)
    for k, g in want.items():
        if k.startswith("params/"):
            assert np.abs(got[k] - g).max() <= 1e-6 * np.abs(g).max(), k
        elif update_bn:
            np.testing.assert_allclose(got[k], g, rtol=1e-6, atol=0,
                                       err_msg=k)
