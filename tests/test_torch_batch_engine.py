"""The port's multi-stream engine (``BatchVideoSegEngine``, float32) on the
CPU, with the JAX package's PRNGKey(0) weights carried across by the
weight bridge: two streams of 48 x 64 frames, three steps.

- Against the JAX package's ``BatchVideoSegEngine``: labels agree on
  > 0.999 of pixels (the bar of tests/test_torch_video_seg.py); the banks'
  ``valid`` and ``occ`` are equal and the keys within 1e-4 (the two
  frameworks' convolutions sum in other orders).
- Against the port's single-stream engine run on each stream alone, with
  the device cleanup (the CC's plain version over the B maps at once):
  labels > 0.999, every stream's ``valid`` and ``occ`` equal.
- The model's stream methods against the JAX model's per-stream calls
  (what its batch engine vmaps): ``memorize_streams`` keys and values of
  B frames with two objects each, and ``segment_streams`` of B frames
  against their folded banks, whose decoder runs at bs = B with two
  objects: scores within 1e-4 of their scale (tests/test_torch_models.py),
  counts within 1, in the JAX vmap's stream-major order.
- ``memorize_every = 2``: a read-only step leaves keys, valid and occ as
  they were and keeps the usage live; the next full step updates the bank
  (the mirror of tests/test_batch_video.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfloodnet_tpu.memory import FeatureBank as JFeatureBank
from vfloodnet_tpu.models import AFBURR as JAFBURR
from vfloodnet_tpu.pipelines.video_seg_batch import \
    BatchVideoSegEngine as JBatchEngine
from vfloodnet_tpu_torch.core import convert_afb_urr_variables
from vfloodnet_tpu_torch.memory import FeatureBank
from vfloodnet_tpu_torch.models import AFBURR
from vfloodnet_tpu_torch.pipelines import (BatchVideoSegEngine,
                                           VideoSegEngine)

torch.set_num_threads(4)
HW, B, STEPS, BUDGET = (48, 64), 2, 3, 1024


@pytest.fixture(scope="module")
def weights():
    jm = JAFBURR(read_chunk=128)
    variables = jax.jit(lambda key: jm.init(
        key, jnp.zeros(HW + (3,)), jnp.zeros((2,) + HW),
        method=jm.init_all))(jax.random.PRNGKey(0))
    port = AFBURR().eval()
    port.load_state_dict(convert_afb_urr_variables(variables))
    return jm, variables, port


def _clips(seed=0):
    """B streams of STEPS + 1 frames, and first masks that differ."""
    rng = np.random.RandomState(seed)
    vids = [[rng.rand(*HW, 3).astype(np.float32) for _ in range(STEPS + 1)]
            for _ in range(B)]
    masks = []
    for v in range(B):
        m = np.zeros(HW, np.uint8)
        m[20 + 4 * v:, :] = 1
        masks.append(m)
    return vids, masks


def _run_batch(engine, vids, masks):
    state = engine.bootstrap([v[0] for v in vids], masks)
    labels = []
    for i in range(STEPS):
        state, lab = engine.step(state, np.stack([v[i + 1] for v in vids]),
                                 i + 1)
        labels.append(engine.fetch_labels(lab))
    return state, np.stack(labels, axis=1)      # [B, STEPS, H, W]


def test_batch_engine_matches_jax_batch_engine(weights):
    jm, variables, port = weights
    vids, masks = _clips()
    jstate, want = _run_batch(
        JBatchEngine(jm, variables, JFeatureBank(obj_n=2,
                                                 memory_budget=BUDGET),
                     batch=B, downsample=48, postprocess="none"),
        vids, masks)
    state, got = _run_batch(
        BatchVideoSegEngine(port, FeatureBank(obj_n=2, memory_budget=BUDGET,
                                              device="cpu"),
                            batch=B, downsample=48, postprocess="none"),
        vids, masks)
    assert got.shape == (B, STEPS) + HW and got.dtype == np.uint8
    agreement = (got == want).mean()
    assert agreement > 0.999, agreement
    # JAX keeps a leading stream axis; the port folds it into the objects
    rows = B * 2
    np.testing.assert_array_equal(state.occ.numpy(),
                                  np.asarray(jstate.occ).reshape(rows))
    np.testing.assert_array_equal(
        state.valid.numpy(), np.asarray(jstate.valid).reshape(rows, -1))
    np.testing.assert_allclose(
        state.keys.numpy(),
        np.asarray(jstate.keys).reshape(state.keys.shape), rtol=1e-4,
        atol=1e-4)


def test_batch_engine_matches_single_stream_engines(weights):
    _, _, port = weights
    vids, masks = _clips(seed=1)
    state, got = _run_batch(
        BatchVideoSegEngine(port, FeatureBank(obj_n=2, memory_budget=BUDGET,
                                              device="cpu"),
                            batch=B, downsample=48, postprocess="device"),
        vids, masks)
    for v in range(B):
        eng = VideoSegEngine(port, FeatureBank(obj_n=2, memory_budget=BUDGET,
                                               device="cpu"),
                             downsample=48, postprocess="device")
        st = eng.bootstrap(vids[v][0], masks[v])
        want = []
        for i in range(STEPS):
            st, lab = eng.step(st, vids[v][i + 1], i + 1)
            want.append(eng.fetch_label(lab))
        agreement = (got[v] == np.stack(want)).mean()
        assert agreement > 0.999, (v, agreement)
        rows = slice(2 * v, 2 * v + 2)
        assert torch.equal(state.occ[rows], st.occ)
        assert torch.equal(state.valid[rows], st.valid)


def test_stream_methods_match_jax_per_stream(weights):
    jm, variables, port = weights
    rng = np.random.RandomState(5)
    frames = rng.rand(B, 60, 90, 3).astype(np.float32)
    masks = np.zeros((B, 2, 60, 90), np.float32)
    masks[0, 1, 30:] = 1.0
    masks[1, 1, :, 40:] = 1.0
    masks[:, 0] = 1.0 - masks[:, 1]
    keys = rng.randn(B * 2, 256, 128).astype(np.float32)
    values = rng.randn(B * 2, 256, 512).astype(np.float32)
    valid = np.zeros((B * 2, 256), bool)
    occ = np.array([24, 24, 40, 40], np.int32)
    with torch.no_grad():
        k4, v4 = port.memorize_streams(torch.from_numpy(frames),
                                       torch.from_numpy(masks))
    for s in range(B):
        jk, jv = jm.apply(variables, jnp.asarray(frames[s]),
                          jnp.asarray(masks[s]), method=jm.memorize)
        rows = slice(2 * s, 2 * s + 2)
        for got, want in ((k4[rows], jk), (v4[rows], jv)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-4, atol=1e-4)
        keys[rows, :24] = np.asarray(jk)[:, :24]
        values[rows, :24] = np.asarray(jv)[:, :24]
        valid[rows, :occ[2 * s]] = True
    with torch.no_grad():
        score, cnt = port.segment_streams(
            *map(torch.from_numpy, (frames, keys, values, valid)),
            bank_occ=torch.from_numpy(occ))
    assert score.shape == (B, 2, 60, 90) and cnt.shape == (B * 2, 256)
    for s in range(B):
        rows = slice(2 * s, 2 * s + 2)
        # the JAX batch engine passes every stream the bound of all
        want, _, want_cnt = jm.apply(
            variables, jnp.asarray(frames[s:s + 1]),
            *map(jnp.asarray, (keys[rows], values[rows], valid[rows])),
            False, bank_occ=jnp.asarray(occ), method=jm.segment)
        want = np.asarray(want)[0]
        np.testing.assert_allclose(score[s].numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())
        np.testing.assert_allclose(cnt[rows].numpy(), np.asarray(want_cnt),
                                   atol=1.0)
    assert cnt.sum() > 0


def test_batch_engine_memorize_every_skips_bank_updates(weights):
    _, _, port = weights
    vids, masks = _clips(seed=2)
    eng = BatchVideoSegEngine(port, FeatureBank(obj_n=2,
                                                memory_budget=BUDGET,
                                                device="cpu"),
                              batch=B, downsample=48, postprocess="none",
                              memorize_every=2)
    state = eng.bootstrap([v[0] for v in vids], masks)
    before = {k: getattr(state, k).clone()
              for k in ("keys", "valid", "occ", "usage")}
    frames = np.stack([v[1] for v in vids])
    state, _ = eng.step(state, frames, 1)            # 1 % 2: read-only
    for k in ("keys", "valid", "occ"):
        assert torch.equal(getattr(state, k), before[k]), k
    assert not torch.equal(state.usage, before["usage"])   # usage live
    usage1, birth1 = state.usage.clone(), state.birth.clone()
    state, _ = eng.step(state, frames, 2)            # full step
    assert not torch.equal(state.keys, before["keys"]) \
        or not torch.equal(state.occ, before["occ"]) \
        or not torch.equal(state.usage, usage1)
    assert (state.birth == 2.0).any() and not (birth1 == 2.0).any()
