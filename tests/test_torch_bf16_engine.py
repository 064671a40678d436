"""The bf16 configuration's models and engine with random-init weights:
the port's ``AFBURR(dtype=torch.bfloat16)`` and bf16 ``VideoSegEngine``
against the JAX package's ``AFBURR(dtype=jnp.bfloat16)`` with
``cast_floating_params`` and its bf16 engine, on the CPU, with the
PRNGKey(0) weights carried across by the weight bridge.

bf16 is not exact, and the two frameworks round at other places (their
convolutions sum in other orders before rounding to bf16, and the port's
read takes float32 scores where the JAX engine's keeps bf16 ones). Over a
clip the differences compound through the bank: on the clip below the JAX
package's own bf16 engine agrees with its float32 engine on only 93.8 % of
the labels. So:

- ``memorize`` keys and values with a mean absolute difference under 2e-2
  of their mean magnitude; one ``segment`` call's labels agree on > 95 %
  of pixels, the bar of tests/test_bf16.py;
- over the 3-frame engine clip, the port's bf16 labels agree with the JAX
  bf16 engine's at least as well as the JAX bf16 engine's agree with the
  JAX float32 engine's, less 0.01 (a fixed bar of 0.95 would be above that
  reference gap).

The trained-weight checks are in tests/test_torch_bf16_trained.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfloodnet_tpu.memory import FeatureBank as JFeatureBank
from vfloodnet_tpu.models import AFBURR as JAFBURR
from vfloodnet_tpu.pipelines.loaders import \
    cast_floating_params as j_cast_floating_params
from vfloodnet_tpu.pipelines.video_seg import VideoSegEngine as JEngine
from vfloodnet_tpu_torch.core import convert_afb_urr_variables
from vfloodnet_tpu_torch.memory import FeatureBank
from vfloodnet_tpu_torch.models import AFBURR
from vfloodnet_tpu_torch.pipelines import cast_floating_params
from vfloodnet_tpu_torch.pipelines.video_seg import VideoSegEngine

torch.set_num_threads(4)
BF = torch.bfloat16


@pytest.fixture(scope="module")
def random_init():
    """JAX bf16 model with PRNGKey(0) weights (float32 masters; the
    compute dtype does not change them) and the port's bf16 model with the
    same masters."""
    j32 = JAFBURR(read_chunk=128)
    variables = jax.jit(lambda key: j32.init(
        key, jnp.zeros((48, 64, 3)), jnp.zeros((2, 48, 64)),
        method=j32.init_all))(jax.random.PRNGKey(0))
    jm = JAFBURR(read_chunk=128, dtype=jnp.bfloat16)
    port = AFBURR(dtype=BF).eval()
    port.load_state_dict(convert_afb_urr_variables(variables))
    return jm, variables, port


def _inputs(seed=1):
    rng = np.random.RandomState(seed)
    frame = rng.rand(64, 48, 3).astype(np.float32)
    mask = np.zeros((2, 64, 48), np.float32)
    mask[1, 16:48, 8:40] = 1.0
    mask[0] = 1.0 - mask[1]
    return frame, mask, rng.rand(1, 64, 48, 3).astype(np.float32)


def test_bf16_memorize_and_segment_match_jax(random_init):
    jm, variables, port = random_init
    cast_vars = j_cast_floating_params(variables, jnp.bfloat16)
    model = cast_floating_params(port, BF)
    frame, mask, frame1 = _inputs()
    jk, jv = jax.jit(functools.partial(jm.apply, method=jm.memorize))(
        cast_vars, jnp.asarray(frame), jnp.asarray(mask))
    with torch.no_grad():
        tk, tv = model.memorize(torch.from_numpy(frame),
                                torch.from_numpy(mask))
    assert tk.dtype == BF and tv.dtype == BF
    for got, want in ((tk, jk), (tv, jv)):
        want = np.asarray(want, np.float32)
        diff = np.abs(got.float().numpy() - want)
        assert diff.mean() < 2e-2 * np.abs(want).mean()

    jfb = JFeatureBank(obj_n=2, memory_budget=2048, dtype=jnp.bfloat16)
    jstate = jfb.init_bank(jk, jv)
    jscore, _, _ = jax.jit(functools.partial(jm.apply, method=jm.segment),
                           static_argnums=5)(
        cast_vars, jnp.asarray(frame1), jstate.keys, jstate.values,
        jstate.valid, False)
    fb = FeatureBank(obj_n=2, memory_budget=2048, dtype=BF, device="cpu")
    state = fb.init_bank(tk, tv)
    with torch.no_grad():
        score, cnt = model.segment(torch.from_numpy(frame1), state.keys,
                                   state.values, state.valid)
    assert score.dtype == torch.float32 and cnt.dtype == torch.float32
    agreement = (score.argmax(1).numpy() ==
                 np.asarray(jnp.argmax(jscore, axis=1))).mean()
    assert agreement > 0.95, agreement


def test_bf16_engine_matches_jax_bf16_engine(random_init):
    jm, variables, port = random_init
    rng = np.random.RandomState(123)
    frames = [rng.rand(48, 64, 3).astype(np.float32) for _ in range(4)]
    mask0 = np.zeros((48, 64), np.uint8)
    mask0[24:, :] = 1

    def run(eng):
        state = eng.bootstrap(frames[0], mask0)
        labels = []
        for i, f in enumerate(frames[1:]):
            state, lab = eng.step(state, f, i + 1)
            labels.append(eng.fetch_label(lab))
        return state, np.stack(labels)

    j16 = run(JEngine(jm, variables,
                      JFeatureBank(obj_n=2, memory_budget=1024,
                                   dtype=jnp.bfloat16),
                      downsample=48, postprocess="none"))[1]
    j32 = run(JEngine(JAFBURR(read_chunk=128), variables,
                      JFeatureBank(obj_n=2, memory_budget=1024),
                      downsample=48, postprocess="none"))[1]
    teng = VideoSegEngine(port, FeatureBank(obj_n=2, memory_budget=1024,
                                            dtype=BF, device="cpu"),
                          downsample=48, postprocess="none")
    assert teng.model is not port and \
        teng.model.keyval_r4.conv.weight.dtype == BF
    state, t16 = run(teng)
    assert state.keys.dtype == BF and state.usage.dtype == torch.float32
    reference_gap = (j16 == j32).mean()
    agreement = (t16 == j16).mean()
    assert agreement >= reference_gap - 0.01, (agreement, reference_gap)
