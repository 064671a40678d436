"""The arithmetic of the CUDA bank read and count kernels (3xTF32 on the
tensor cores), emulated in numpy on the CPU, against the JAX package's
occupancy-bounded read ``vfloodnet_tpu.ops.attention._xla_read_occ``.

The kernels split each float32 operand x into hi = trunc(x) and
lo = trunc(x - hi), where trunc clears the low 13 mantissa bits (the TF32
operand the tensor cores read), and form a . b as lo_a hi_b + hi_a lo_b +
hi_a hi_b with float32 sums, for both products of the read (Q K^T and
P V) and for the count's scores. The emulation below applies the same
split; its sums are numpy's float32 matrix products. The read is cut
into the kernel's bank segments and merged by the port's
``combine_partials``. This shows, without a card, that the design's
numerics meet the bars of ``tests/test_attention_pallas.py`` and
``chip_smoke.py``: mem rtol 2e-4 / atol 2e-5, counts |diff| <= 1 per slot.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfloodnet_tpu.ops import attention as jatt
from vfloodnet_tpu_torch.ops import attention as tatt
from vfloodnet_tpu_torch.ops import bank_read_cuda

THRES = 1e-3
N, DK, DV, CHUNK = 20000, 128, 512, 8192


def _trunc(x):
    """Clear the low 13 mantissa bits of float32 x: its TF32 value."""
    return (np.ascontiguousarray(x, np.float32).view(np.uint32)
            & np.uint32(0xffffe000)).view(np.float32)


def _split(x):
    hi = _trunc(x)
    return hi, _trunc(x - hi)


def _mm3(a, b):
    """a @ b in 3xTF32: lo_a hi_b + hi_a lo_b + hi_a hi_b."""
    ah, al = _split(a)
    bh, bl = _split(b)
    return (al @ bh + ah @ bl) + ah @ bh


def _emulated_read(keys, values, valid, q, occ, splits):
    """The kernels' read, combine and count with 3xTF32 products:
    (mem [P, dv], cnt [N])."""
    n = keys.shape[0]
    n_visit = tatt.visited_slots(n, CHUNK, occ)
    seg = tatt.segment_length(n_visit, splits, bank_read_cuda.READ_TILE)
    rows = max(n, n_visit)
    k_p = np.zeros((rows, DK), np.float32)
    v_p = np.zeros((rows, DV), np.float32)
    ok_p = np.zeros(rows, bool)
    k_p[:n], v_p[:n], ok_p[:n] = keys, values, valid
    scale = np.float32(1.0 / math.sqrt(DK))
    s = _mm3(q, k_p[:n_visit].T) * scale
    s = np.where(ok_p[None, :n_visit], s, np.float32(-1e30))
    p = q.shape[0]
    m_s = np.full((splits, p), -np.inf, np.float32)
    l_s = np.zeros((splits, p), np.float32)
    acc_s = np.zeros((splits, p, DV), np.float32)
    for i in range(splits):
        lo, hi = i * seg, min((i + 1) * seg, n_visit)
        if lo >= hi:
            continue
        m_s[i] = s[:, lo:hi].max(1)
        e = np.exp(s[:, lo:hi] - m_s[i][:, None]).astype(np.float32)
        l_s[i] = e.sum(1, dtype=np.float32)
        acc_s[i] = _mm3(e, v_p[lo:hi])
    mem, _, _, log_thres = tatt.combine_partials(
        *map(torch.from_numpy, (m_s, l_s, acc_s)), THRES)
    n_real = min(n_visit, n)
    hit = (s[:, :n_real] > log_thres.numpy()[:, None]) & valid[None, :n_real]
    cnt = np.zeros(n, np.float32)
    cnt[:n_real] = hit.sum(0)
    return mem.numpy(), cnt


def test_split_is_exact_tf32():
    rng = np.random.RandomState(0)
    x = (rng.randn(4096) * 10.0 ** rng.uniform(-3, 3, 4096)).astype(
        np.float32)
    hi, lo = _split(x)
    for part in (hi, lo):
        assert not (part.view(np.uint32) & np.uint32(0x1fff)).any()
    # hi + lo holds x to 22 significant bits
    err = np.abs(x.astype(np.float64) - hi - lo.astype(np.float64))
    assert (err <= np.abs(x) * 2.0 ** -20).all()


@pytest.mark.parametrize("p", [37, 200])
@pytest.mark.parametrize("occ", [9000, N])
def test_3xtf32_read_and_count_match_jax(p, occ):
    rng = np.random.RandomState(p + occ)
    keys = rng.randn(N, DK).astype(np.float32)
    values = rng.randn(N, DV).astype(np.float32)
    valid = rng.rand(N) < 0.9
    q = (3.0 * rng.randn(p, DK)).astype(np.float32)   # as in chip_smoke.py
    want_mem, want_cnt = map(np.asarray, jatt._xla_read_occ(
        *map(jnp.asarray, (keys, values, valid, q)), THRES, CHUNK,
        jnp.int32(occ)))
    splits = bank_read_cuda.default_splits(2, p, 132)
    mem, cnt = _emulated_read(keys, values, valid, q, occ, splits)
    np.testing.assert_allclose(mem, want_mem, rtol=2e-4, atol=2e-5)
    assert want_cnt.sum() > 0
    assert np.abs(cnt - want_cnt).max() <= 1.0
    n_visit = tatt.visited_slots(N, CHUNK, occ)
    assert (cnt[n_visit:] == 0).all()
