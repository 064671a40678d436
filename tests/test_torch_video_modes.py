"""The engine's modes against the JAX engine and against themselves, on
the CPU with random-init weights (the clip of tests/test_torch_video_seg.py):

- ``memorize_every=2``: odd frames run the read-only step; labels agree
  with the JAX engine's on > 0.999 and the occupancy is equal;
- ``step_n`` against K calls of ``step`` from the same bank: labels agree
  on > 0.999 and every bank tensor is equal; ``step_n`` refuses
  ``memorize_every=2`` as the JAX engine does;
- the read-only step records usage and leaves the rest of the bank as it
  was.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfloodnet_tpu.memory import FeatureBank as JFeatureBank
from vfloodnet_tpu.models import AFBURR as JAFBURR
from vfloodnet_tpu.pipelines.video_seg import VideoSegEngine as JEngine
from vfloodnet_tpu_torch.core import convert_afb_urr_variables
from vfloodnet_tpu_torch.memory import FeatureBank
from vfloodnet_tpu_torch.models import AFBURR
from vfloodnet_tpu_torch.pipelines.video_seg import VideoSegEngine

torch.set_num_threads(4)
BANK = ("keys", "values", "valid", "birth", "usage", "occ", "peak_n",
        "replace_n")


@pytest.fixture(scope="module")
def random_init():
    jm = JAFBURR(read_chunk=128)
    variables = jax.jit(lambda key: jm.init(
        key, jnp.zeros((48, 64, 3)), jnp.zeros((2, 48, 64)),
        method=jm.init_all))(jax.random.PRNGKey(0))
    port = AFBURR().eval()
    port.load_state_dict(convert_afb_urr_variables(variables))
    return jm, variables, port


def _clip(seed=123, n=5, hw=(48, 64)):
    rng = np.random.RandomState(seed)
    frames = [rng.rand(*hw, 3).astype(np.float32) for _ in range(n)]
    mask0 = np.zeros(hw, np.uint8)
    mask0[hw[0] // 2:, :] = 1
    return frames, mask0


def _engine(port, **kw):
    return VideoSegEngine(port, FeatureBank(obj_n=2, memory_budget=1024,
                                            device="cpu"),
                          downsample=48, postprocess="none", **kw)


def test_memorize_every_2_matches_jax_engine(random_init):
    jm, variables, port = random_init
    frames, mask0 = _clip()
    jeng = JEngine(jm, variables, JFeatureBank(obj_n=2, memory_budget=1024),
                   downsample=48, postprocess="none", memorize_every=2)
    teng = _engine(port, memorize_every=2)
    js = jeng.bootstrap(frames[0], mask0)
    ts = teng.bootstrap(frames[0], mask0)
    want, got, occ = [], [], [ts.occ.tolist()]
    for i, f in enumerate(frames[1:]):
        js, jl = jeng.step(js, f, i + 1)
        ts, tl = teng.step(ts, f, i + 1)
        want.append(jeng.fetch_label(jl))
        got.append(teng.fetch_label(tl))
        np.testing.assert_array_equal(ts.occ.numpy(), np.asarray(js.occ))
        occ.append(ts.occ.tolist())
    np.testing.assert_allclose(ts.usage.numpy(), np.asarray(js.usage),
                               atol=1e-4)
    agreement = (np.stack(got) == np.stack(want)).mean()
    assert agreement > 0.999, agreement
    # only frames 2 and 4 memorize
    assert occ[1] == occ[0] and occ[3] == occ[2]
    assert occ[2] > occ[1] and occ[4] > occ[3]


def test_step_n_matches_steps(random_init):
    _, _, port = random_init
    frames, mask0 = _clip(seed=5)
    outs = []
    for batched in (False, True):
        eng = _engine(port)
        state = eng.bootstrap(frames[0], mask0)
        state, _ = eng.step(state, frames[1], 1)
        if batched:
            state, labels = eng.step_n(state, np.stack(frames[2:]), 2)
            labels = eng.fetch_labels(labels)
        else:
            labels = []
            for i, f in enumerate(frames[2:]):
                state, lab = eng.step(state, f, 2 + i)
                labels.append(eng.fetch_label(lab))
            labels = np.stack(labels)
        outs.append((state, labels))
    (s1, l1), (s2, l2) = outs
    assert l2.shape == (3, 48, 64)
    assert (l1 == l2).mean() > 0.999
    for name in BANK:
        assert torch.equal(getattr(s1, name), getattr(s2, name)), name


def test_step_n_refuses_memorize_every_2(random_init):
    _, _, port = random_init
    frames, mask0 = _clip(n=3)
    eng = _engine(port, memorize_every=2)
    state = eng.bootstrap(frames[0], mask0)
    with pytest.raises(ValueError, match="memorize_every == 1"):
        eng.step_n(state, np.stack(frames[1:]), 1)


def test_read_only_step_changes_only_usage(random_init):
    _, _, port = random_init
    frames, mask0 = _clip(n=2)
    eng = _engine(port, memorize_every=3)
    state = eng.bootstrap(frames[0], mask0)
    before = {k: getattr(state, k).clone() for k in BANK}
    state, label = eng.step(state, frames[1], 1)     # 1 % 3: read-only
    for name in BANK:
        same = torch.equal(getattr(state, name), before[name])
        assert same == (name != "usage"), name
    assert eng.fetch_label(label).shape == (48, 64)


def test_engine_refuses_graphs_off_the_card(random_init):
    _, _, port = random_init
    with pytest.raises(ValueError, match="CUDA device"):
        _engine(port, cuda_graph=True)
    assert _engine(port).cuda_graph is False
