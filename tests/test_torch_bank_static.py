"""The port's static-shape bank update against the JAX package's:
``bank_merge_append`` (``FeatureBank`` in
``tests/test_torch_feature_bank_static.py``).

Both sides run on the same numpy inputs: below capacity, crossing it,
full (over two occupancy chunks), all merged, none merged, many features
on one slot, and LFU priorities with many ties. Keys and values within
atol 1e-5 (the merge means are summed in another order), everything else
exactly. Keys are compared
slot by slot, so a victim taken in another order than JAX's ``top_k``
fails. The port also gets a looser occupancy bound than the true one
(more chunks visited, the LFU selection opened early), which must not
change anything.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfloodnet_tpu.ops.bank_update import bank_merge_append as j_merge
from vfloodnet_tpu_torch.ops import bank_update

torch.set_num_threads(2)
_J_MERGE = jax.jit(j_merge)


def _case(rng, n, occ, m, merged, one_slot, ties, dk=8, dv=12):
    keys = np.zeros((n, dk), np.float32)
    values = np.zeros((n, dv), np.float32)
    keys[:occ] = rng.randn(occ, dk)
    values[:occ] = rng.randn(occ, dv)
    valid = np.arange(n) < occ
    birth = np.where(valid, rng.randint(0, 5, n), 0).astype(np.float32)
    usage = np.where(valid, rng.rand(n) * 10, 0).astype(np.float32)
    if ties:      # whole runs of equal LFU priority
        usage = np.where(valid, rng.randint(0, 3, n), 0).astype(np.float32)
        birth[:] = 0.0
    new_k = rng.randn(m, dk).astype(np.float32)
    new_v = rng.randn(m, dv).astype(np.float32)
    if merged:    # near-copies of occupied slots: merged
        src = (np.zeros(merged, int) if one_slot
               else rng.choice(occ, merged, replace=False))
        new_k[:merged] = keys[src] * 2.0 + 0.01 * rng.randn(merged, dk)
    return keys, values, valid, birth, usage, new_k, new_v


CASES = {   # name: (n, occ, m, merged, one_slot, ties)
    "below_capacity": (64, 20, 12, 4, False, False),
    "crossing_capacity": (64, 58, 12, 3, False, False),
    "all_merged": (64, 40, 12, 12, False, False),
    "none_merged": (64, 60, 12, 0, False, True),
    "one_slot": (64, 30, 12, 9, True, False),
    "full": (8192 + 2048, 10240, 40, 6, False, True),   # two chunks
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_merge_append_matches_jax_slot_by_slot(name):
    n, occ, m, merged, one_slot, ties = CASES[name]
    rng = np.random.RandomState(len(name) + n + occ)
    bank = _case(rng, n, occ, m, merged, one_slot, ties)
    frame_idx = 7.0
    wk, wv, wok, wb, wu, wocc, wstats = _J_MERGE(
        *map(jnp.asarray, bank), jnp.float32(frame_idx), occ=jnp.int32(occ),
        occ_bound=jnp.int32(occ))
    for bound in (occ, n):              # exact, then as loose as it gets
        t = [torch.tensor(a) for a in bank]
        occ_new, stats = bank_update.bank_merge_append(
            *t[:5], t[5], t[6], torch.tensor(frame_idx),
            torch.tensor(occ, dtype=torch.int32), bound)
        assert int(occ_new) == int(wocc)
        assert [int(x) for x in stats] == [int(wstats.merged_n),
                                           int(wstats.appended_n),
                                           int(wstats.evicted_n)]
        for got, want in zip(t[:5], (wk, wv, wok, wb, wu)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-5, err_msg=name)
    assert int(stats.merged_n) >= merged
    if name in ("full", "crossing_capacity", "none_merged"):
        assert int(stats.evicted_n) > 0
