"""Port feature-bank update vs the JAX package's (its exact top_k branch).

The bank contents are compared after the update: keys and values atol
1e-5 (the merge means are summed in another order), everything else
exactly. Where LFU eviction runs, the set of overwritten slots is compared
as a set.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfloodnet_tpu.memory import FeatureBank as JFeatureBank
from vfloodnet_tpu.ops.bank_update import bank_merge_append as j_merge
from vfloodnet_tpu_torch.memory import FeatureBank
from vfloodnet_tpu_torch.ops import bank_merge_append

torch.set_num_threads(2)


def _bank(rng, n, occ, dk, dv, m, n_dup):
    keys = np.zeros((n, dk), np.float32)
    values = np.zeros((n, dv), np.float32)
    keys[:occ] = rng.randn(occ, dk)
    values[:occ] = rng.randn(occ, dv)
    valid = np.arange(n) < occ
    birth = np.where(valid, rng.randint(0, 5, n), 0).astype(np.float32)
    usage = np.where(valid, rng.rand(n) * 10, 0).astype(np.float32)
    new_k = rng.randn(m, dk).astype(np.float32)
    new_v = rng.randn(m, dv).astype(np.float32)
    # near-duplicates of occupied slots merge (two of them into one slot)
    src = rng.choice(occ, n_dup, replace=False)
    src[1] = src[0]
    new_k[:n_dup] = keys[src] * 2.0 + 0.01 * rng.randn(n_dup, dk)
    return keys, values, valid, birth, usage, new_k, new_v


def _compare(got, want, n):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


@pytest.mark.parametrize("n,occ,m,evict", [
    (64, 20, 12, False),              # below capacity: merge + append
    (64, 60, 12, True),               # LFU eviction active
    (8192 + 2048, 9000, 40, False),   # bounded match over two 8192-chunks
    (8192 + 2048, 10230, 40, True),   # full multi-chunk bank, eviction
])
def test_merge_append_matches_jax(n, occ, m, evict):
    rng = np.random.RandomState(n + occ)
    dk, dv = 8, 12
    bank = _bank(rng, n, occ, dk, dv, m, n_dup=4)
    keys, values, valid, birth, usage, new_k, new_v = bank
    frame_idx = 7.0
    occ_bound = occ + 3 if not evict else occ   # a second, fuller object
    wk, wv, wok, wb, wu, wocc, wstats = j_merge(
        *map(jnp.asarray, bank), jnp.float32(frame_idx), occ=jnp.int32(occ),
        occ_bound=jnp.int32(occ_bound))

    t = [torch.tensor(a) for a in bank]
    occ_new, stats = bank_merge_append(*t[:5], t[5], t[6], frame_idx,
                                       occ=occ, occ_bound=occ_bound)
    assert occ_new == int(wocc)
    assert (stats.merged_n, stats.appended_n, stats.evicted_n) == \
        (int(wstats.merged_n), int(wstats.appended_n), int(wstats.evicted_n))
    assert stats.merged_n >= 4 and (stats.evicted_n > 0) == evict
    _compare(t[:5], (wk, wv, wok, wb, wu), n)
    # the overwritten (victim) slots are the same set
    got_written = set(np.flatnonzero(t[3].numpy() == frame_idx))
    want_written = set(np.flatnonzero(np.asarray(wb) == frame_idx))
    assert got_written == want_written


def test_feature_bank_capacity_matches_jax():
    for obj_n, budget in [(2, 250_000), (2, 65_536), (2, 1024), (3, 50_000)]:
        assert FeatureBank(obj_n, budget, device="cpu").class_budget == \
            JFeatureBank(obj_n, budget).class_budget
    assert FeatureBank(2, 250_000, device="cpu").class_budget == 98304


def test_feature_bank_update_and_usage_match_jax():
    rng = np.random.RandomState(11)
    obj_n, dk, dv, p = 2, 8, 8, 96
    jfb = JFeatureBank(obj_n, memory_budget=640, keydim=dk, valdim=dv)
    tfb = FeatureBank(obj_n, memory_budget=640, keydim=dk, valdim=dv,
                      device="cpu")
    assert tfb.class_budget == 256
    k0 = rng.randn(obj_n, p, dk).astype(np.float32)
    v0 = rng.randn(obj_n, p, dv).astype(np.float32)
    js = jfb.init_bank(jnp.asarray(k0), jnp.asarray(v0))
    ts = tfb.init_bank(torch.tensor(k0), torch.tensor(v0))
    for frame in range(1, 5):        # fills 256 slots by frame 2, then evicts
        cnt = rng.randint(0, 4, (obj_n, tfb.class_budget)).astype(np.float32)
        js = jfb.record_usage(js, jnp.asarray(cnt))
        ts = tfb.record_usage(ts, torch.tensor(cnt))
        nk = rng.randn(obj_n, p, dk).astype(np.float32)
        nv = rng.randn(obj_n, p, dv).astype(np.float32)
        js = jfb.update(js, jnp.asarray(nk), jnp.asarray(nv), frame)
        ts = tfb.update(ts, torch.tensor(nk), torch.tensor(nv), frame)
        for name in ("keys", "values", "valid", "birth", "usage", "occ",
                     "peak_n", "replace_n"):
            np.testing.assert_allclose(
                getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                atol=1e-5, err_msg=f"{name} at frame {frame}")
    assert int(ts.replace_n.sum()) > 0
    assert tfb.report(ts) == jfb.report(js)


def test_feature_bank_append_matches_jax():
    rng = np.random.RandomState(9)
    jfb = JFeatureBank(obj_n=2, memory_budget=1024, keydim=8, valdim=8)
    tfb = FeatureBank(obj_n=2, memory_budget=1024, keydim=8, valdim=8,
                      device="cpu")
    k0 = rng.randn(2, 500, 8).astype(np.float32)
    v0 = rng.randn(2, 500, 8).astype(np.float32)
    js = jfb.init_bank(jnp.asarray(k0), jnp.asarray(v0))
    ts = tfb.init_bank(torch.tensor(k0), torch.tensor(v0))
    for frame, m in ((3.0, 8), (4.0, 16)):       # the second one overflows
        k1 = rng.randn(2, m, 8).astype(np.float32)
        v1 = rng.randn(2, m, 8).astype(np.float32)
        js = jfb.append(js, jnp.asarray(k1), jnp.asarray(v1), frame_idx=frame)
        ts = tfb.append(ts, torch.tensor(k1), torch.tensor(v1),
                        frame_idx=frame)
        for name in ("keys", "values", "valid", "birth", "usage", "occ",
                     "peak_n"):
            np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                          np.asarray(getattr(js, name)))
    assert int(ts.count()[0]) == 512


def test_feature_bank_refuses_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the refusal cannot be observed")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FeatureBank(obj_n=2)
