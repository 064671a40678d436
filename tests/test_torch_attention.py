"""Port bank read (plain versions and the dispatcher) vs the JAX package's
XLA reads and its Pallas kernel in interpret mode.

Tolerances (those of tests/test_attention_pallas.py): mem rtol 2e-4,
atol 2e-5; usage counts atol 1 (a score within float32 rounding of the
threshold may fall either way).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vfloodnet_tpu.ops import attention as jatt
from vfloodnet_tpu.ops.attention_pallas import pallas_bank_read
from vfloodnet_tpu_torch.ops import attention as tatt
from vfloodnet_tpu_torch.ops import bank_attention_read, bank_read_cuda

torch.set_num_threads(2)
MEM_TOL = dict(rtol=2e-4, atol=2e-5)


def _inputs(seed, n, p, dk=16, dv=24, valid_frac=0.7, prefix=None,
            q_scale=2.0):
    """q is scaled up so the softmax is peaked enough for nonzero counts."""
    rng = np.random.RandomState(seed)
    keys = rng.randn(n, dk).astype(np.float32)
    values = rng.randn(n, dv).astype(np.float32)
    valid = rng.rand(n) < valid_frac
    if prefix is not None:
        valid[prefix:] = False
    q = (q_scale * rng.randn(p, dk)).astype(np.float32)
    return keys, values, valid, q


def _torch(*arrays):
    return [torch.tensor(a) for a in arrays]


def _check(got, want):
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **MEM_TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1.0)


@pytest.mark.parametrize("n,p", [(300, 50), (513, 37), (64, 1)])
def test_dense_read_matches_jax(n, p):
    keys, values, valid, q = _inputs(0, n, p)
    want = jatt._xla_read_dense(*map(jnp.asarray, (keys, values, valid, q)),
                                1e-3)
    got = tatt._read_dense(*_torch(keys, values, valid, q), 1e-3)
    assert np.asarray(want[1]).sum() > 0
    _check(got, want)


@pytest.mark.parametrize("n,p,chunk", [(300, 50, 64), (1000, 31, 256),
                                       (200, 7, 17)])
def test_chunked_read_matches_jax(n, p, chunk):
    keys, values, valid, q = _inputs(1, n, p)
    want = jatt._xla_read(*map(jnp.asarray, (keys, values, valid, q)), 1e-3,
                          chunk)
    got = tatt._read_chunked(*_torch(keys, values, valid, q), 1e-3, chunk)
    _check(got, want)


@pytest.mark.parametrize("n,p,chunk,occ", [
    (1000, 40, 256, 300),     # bound cuts the loop to 2 of 4 chunks
    (1000, 40, 256, 1000),    # full bank, ragged last chunk (pad to 1024)
    (1000, 13, 256, 0),       # empty bank: one chunk visited
    (640, 21, 128, 129),      # bound one past a chunk edge
])
def test_occupancy_read_matches_jax(n, p, chunk, occ):
    keys, values, valid, q = _inputs(2, n, p, prefix=occ)
    want = jatt._xla_read_occ(*map(jnp.asarray, (keys, values, valid, q)),
                              1e-3, chunk, jnp.int32(occ))
    got = tatt._read_occ(*_torch(keys, values, valid, q), 1e-3, chunk, occ)
    _check(got, want)
    assert (got[1].numpy()[occ:] == 0).all()


def test_all_invalid_read_matches_jax_and_is_finite():
    keys, values, valid, q = _inputs(3, 300, 20, valid_frac=0.0)
    for want, got in [
        (jatt._xla_read_dense(*map(jnp.asarray, (keys, values, valid, q)),
                              1e-3),
         tatt._read_dense(*_torch(keys, values, valid, q), 1e-3)),
        (jatt._xla_read_occ(*map(jnp.asarray, (keys, values, valid, q)),
                            1e-3, 128, jnp.int32(0)),
         tatt._read_occ(*_torch(keys, values, valid, q), 1e-3, 128, 0)),
    ]:
        _check(got, want)
        assert torch.isfinite(got[0]).all()
        assert float(got[1].sum()) == 0.0


@pytest.mark.parametrize("n,p", [(512, 40), (1000, 30)])
def test_plain_read_matches_pallas_kernel(n, p):
    keys, values, valid, q = _inputs(4, n, p)
    with pltpu.force_tpu_interpret_mode():
        want = pallas_bank_read(*map(jnp.asarray, (keys, values, valid, q)),
                                thres=1e-3, chunk=256)
    got = tatt._read_chunked(*_torch(keys, values, valid, q), 1e-3, 256)
    _check(got, want)


def test_dispatcher_selects_the_jax_variant_per_object():
    """bank_attention_read over [obj, N, d] with an occupancy bound equals
    the JAX read of each object (occupancy variant above 8192 slots)."""
    n, p = tatt.OCC_CHUNK + 1024, 24
    per_obj = [_inputs(5 + o, n, p, dk=8, dv=8, prefix=300 * (o + 1))
               for o in range(2)]
    keys, values, valid = (np.stack([x[i] for x in per_obj])
                           for i in range(3))
    q = per_obj[0][3]
    bound = torch.tensor(600, dtype=torch.int32)
    mem, cnt = bank_attention_read(*_torch(keys, values, valid, q),
                                   occ_bound=bound)
    assert mem.shape == (2, p, 8) and cnt.shape == (2, n)
    for o in range(2):
        want = jatt.bank_attention_read(
            *map(jnp.asarray, (keys[o], values[o], valid[o], q)),
            occ_bound=jnp.int32(600))
        _check((mem[o], cnt[o]), want)


def test_visited_slots_follows_the_occupancy_rounding():
    assert tatt.visited_slots(98304, 8192, 20000) == 24576
    assert tatt.visited_slots(98304, 8192, 98304) == 98304
    assert tatt.visited_slots(98304, 8192, 0) == 8192
    assert tatt.visited_slots(1000, 256, 1000) == 1024
    assert tatt.visited_slots(500, 8192, 7) == 500


# The read kernel's bank split: segments of the plain sweep merged by
# combine_partials. (n, p, chunk, occ, valid_frac): a random bank; an
# all-invalid bank (the mean of the visited slots, padding included); 40
# visited slots in 32-slot segments, so that with 3 or 4 splits whole
# segments lie past the bound; occupancy 0 (one chunk).
@pytest.mark.parametrize("splits", [1, 3, 4])
@pytest.mark.parametrize("n,p,chunk,occ,valid_frac", [
    (1000, 37, 256, 1000, 0.7),
    (1000, 37, 256, 1000, 0.0),
    (1000, 20, 40, 30, 0.7),
    (640, 13, 128, 0, 0.7),
], ids=["random", "all_invalid", "segments_past_bound", "occ0"])
def test_combined_segments_match_single_sweep_and_jax(splits, n, p, chunk,
                                                      occ, valid_frac):
    """mem, m and l of the merged segments against the single-sweep plain
    read, and mem (with the counts that the merged m and l give) against
    the JAX package's _xla_read_occ, which returns no m or l."""
    keys, values, valid, q = _inputs(6, n, p, valid_frac=valid_frac)
    tk, tv, tok, tq = _torch(keys, values, valid, q)
    m_s, l_s, acc_s = tatt._read_occ_segments(tk, tv, tok, tq, chunk, occ,
                                              splits)
    n_visit = tatt.visited_slots(n, chunk, occ)
    seg = tatt.segment_length(n_visit, splits, 32)
    for s in range(splits):
        if s * seg >= n_visit:   # a segment wholly past the bound
            assert (m_s[s] == -float("inf")).all() and (l_s[s] == 0).all()
            assert (acc_s[s] == 0).all()
    mem, m, l, log_thres = tatt.combine_partials(m_s, l_s, acc_s, 1e-3)
    assert torch.isfinite(mem).all() and torch.isfinite(log_thres).all()
    want_mem, want_m, want_l = tatt._read_occ_sweep(tk, tv, tok, tq, chunk,
                                                    occ)
    torch.testing.assert_close(mem, want_mem, **MEM_TOL)
    torch.testing.assert_close(m, want_m, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(l, want_l, rtol=1e-5, atol=0)
    cnt = tatt._count_occ_sweep(tk, tok, tq, log_thres, chunk, occ)
    want = jatt._xla_read_occ(*map(jnp.asarray, (keys, values, valid, q)),
                              1e-3, chunk, jnp.int32(occ))
    _check((mem, cnt), want)
    if valid_frac == 0.0:   # every visited slot weighs the same
        padded = torch.cat([tv, tv.new_zeros(n_visit - n, tv.shape[1])]) \
            if n_visit > n else tv[:n_visit]
        torch.testing.assert_close(mem, padded.mean(0).expand_as(mem),
                                   **MEM_TOL)


def test_segment_length_and_default_splits():
    # 16,384 visited slots in 5 segments: 3,277 rounded up to 3,296
    assert tatt.segment_length(16384, 5, 32) == 3296
    assert tatt.segment_length(40, 4, 32) == 32
    assert tatt.segment_length(98304, 1, 32) == 98304
    # main path: 2 objects x 26 query tiles on 132 SMs -> 260 blocks
    assert bank_read_cuda.default_splits(2, 1620, 132) == 5
    assert bank_read_cuda.default_splits(2, 37, 132) == 8
    assert bank_read_cuda.default_splits(66, 64, 132) == 2
