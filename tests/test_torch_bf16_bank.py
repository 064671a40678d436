"""The bf16 configuration's feature bank: the port against the JAX
package on the CPU, from the same numpy inputs.

- The bf16 match and merge against ``_best_match_occ`` and
  ``bank_merge_append``: best index agreement > 0.9 and corr rtol/atol
  0.02 (tests/test_bank_ops.py); after an update in which both chose the
  same merge/append split, the occupancy, validity, birth and usage are
  exact and the keys and values within rtol/atol 2e-2.
- ``FeatureBank(dtype=torch.bfloat16)`` keeps keys and values bf16 and its
  bookkeeping float32 / int32 through init, append and update.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vfloodnet_tpu.memory import FeatureBank as JFeatureBank
from vfloodnet_tpu.ops.bank_update import _best_match_occ
from vfloodnet_tpu.ops.bank_update import _safe_normalize as j_normalize
from vfloodnet_tpu.ops.bank_update import bank_merge_append as j_merge
from vfloodnet_tpu_torch.memory import FeatureBank
from vfloodnet_tpu_torch.ops import bank_update

BF = torch.bfloat16


def _bf(x):
    """A numpy float32 array rounded to bf16 (as JAX rounds it), as the
    JAX array and as the torch tensor."""
    j = jnp.asarray(x, jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j, np.float32)).to(BF)


def test_bf16_best_match_close_to_jax():
    rng = np.random.RandomState(8)
    n, d, m, occ = 20000, 16, 64, 9000
    jk, tk = _bf(rng.randn(n, d).astype(np.float32))
    valid = np.arange(n) < occ
    new, _ = j_normalize(jnp.asarray(rng.randn(m, d).astype(np.float32)))
    j_new, t_new = _bf(np.asarray(new))
    c16, i16 = _best_match_occ(jk, jnp.asarray(valid), j_new,
                               jnp.int32(occ))
    corr, idx = bank_update._best_match(tk, torch.from_numpy(valid), t_new,
                                        occ)
    assert corr.dtype == torch.float32
    assert (idx.numpy() == np.asarray(i16)).mean() > 0.9
    np.testing.assert_allclose(corr.numpy(), np.asarray(c16), rtol=0.02,
                               atol=0.02)


def test_bf16_merge_append_matches_jax():
    """Half of the new features are near-copies of valid slots (cosine
    ~0.99, merged) and half random (appended), so both sides choose the
    same split; the bank then agrees slot for slot."""
    rng = np.random.RandomState(9)
    n, dk, dv, m, occ = 2048, 16, 24, 64, 1500
    keys = rng.randn(n, dk).astype(np.float32)
    values = rng.randn(n, dv).astype(np.float32)
    valid = np.arange(n) < occ
    birth = np.where(valid, rng.randint(0, 5, n), 0).astype(np.float32)
    usage = np.where(valid, rng.rand(n) * 3, 0).astype(np.float32)
    src = rng.choice(occ, m // 2, replace=False)
    new_k = rng.randn(m, dk).astype(np.float32)
    new_v = rng.randn(m, dv).astype(np.float32)
    new_k[: m // 2] = keys[src] + 0.05 * rng.randn(m // 2, dk)
    new_v[: m // 2] = values[src] + 0.05 * rng.randn(m // 2, dv)
    (jk, tk), (jv, tv) = _bf(keys), _bf(values)
    (jnk, tnk), (jnv, tnv) = _bf(new_k), _bf(new_v)
    out = jax.jit(j_merge)(jk, jv, jnp.asarray(valid), jnp.asarray(birth),
                           jnp.asarray(usage), jnk, jnv, jnp.float32(6.0),
                           occ=jnp.int32(occ), occ_bound=jnp.int32(occ))
    jkeys, jvalues, jvalid, jbirth, jusage, jocc, jstats = out
    tvalid, tbirth, tusage = (torch.from_numpy(a.copy())
                              for a in (valid, birth, usage))
    occ_new, stats = bank_update.bank_merge_append(
        tk, tv, tvalid, tbirth, tusage, tnk, tnv, 6.0, occ, occ)
    assert tk.dtype == BF and tv.dtype == BF
    assert stats.merged_n == int(jstats.merged_n) == m // 2
    assert stats.appended_n == int(jstats.appended_n)
    assert occ_new == int(jocc) == occ + m // 2
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(tbirth.numpy(), np.asarray(jbirth))
    np.testing.assert_array_equal(tusage.numpy(), np.asarray(jusage))
    for got, want in ((tk, jkeys), (tv, jvalues)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=2e-2, atol=2e-2)


def test_feature_bank_bf16_keeps_its_types():
    rng = np.random.RandomState(10)
    fb = FeatureBank(obj_n=2, memory_budget=640, keydim=8, valdim=8,
                     dtype=BF, device="cpu")
    jfb = JFeatureBank(obj_n=2, memory_budget=640, keydim=8, valdim=8,
                       dtype=jnp.bfloat16)

    def feats(p):
        return (rng.randn(2, p, 8).astype(np.float32),
                rng.randn(2, p, 8).astype(np.float32))

    def types_of(state):
        return {k: str(getattr(state, k).dtype).split(".")[-1]
                for k in ("keys", "values", "valid", "birth", "usage",
                          "occ", "peak_n", "replace_n")}

    want = {"keys": "bfloat16", "values": "bfloat16", "valid": "bool",
            "birth": "float32", "usage": "float32", "occ": "int32",
            "peak_n": "int32", "replace_n": "int32"}
    k0, v0 = feats(20)
    state = fb.init_bank(torch.from_numpy(k0), torch.from_numpy(v0))
    jstate = jfb.init_bank(jnp.asarray(k0), jnp.asarray(v0))
    assert types_of(state) == types_of(jstate) == want
    k1, v1 = feats(6)
    state = fb.append(state, torch.from_numpy(k1), torch.from_numpy(v1), 1.0)
    assert types_of(state) == want
    k2, v2 = feats(12)
    state = fb.update(state, torch.from_numpy(k2), torch.from_numpy(v2), 2.0)
    assert types_of(state) == want
    assert state.occ.tolist() == [38, 38]
