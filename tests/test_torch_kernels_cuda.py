"""The CUDA bank read, combine and count kernels (float32 and bf16) against
their plain PyTorch versions, on the card. Marked ``cuda``; each test skips
where there is no GPU. Run on a GPU machine with
``python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py``
(``tests/conftest.py`` sets up JAX, which this file does not need).

Tolerances: mem rtol 2e-4, atol 2e-5; counts |diff| <= 1 per slot; m rtol
1e-5 / atol 1e-5 and l rtol 1e-4 against the plain read; the combine kernel
against ``combine_partials`` on the same partials: rtol 1e-5, atol 1e-6
(the same arithmetic, with exp and log of another library). The bf16
kernels on bf16 banks: mem rtol 1e-2 / atol 2e-3 (one bf16 ulp is 3.9e-3
relative), counts within 1, m rtol 1e-5 / atol 1e-5 and l rtol 1e-4 (their
float32 sums of exact bf16 products, in another order than the plain
version's).
"""

import math

import pytest
import torch

from vfloodnet_tpu_torch.ops import attention, bank_read_cuda

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bank(dev, obj, n, p, seed, prefix=None, dtype=torch.float32):
    g = torch.Generator(device=dev).manual_seed(seed)
    keys = torch.randn(obj, n, 128, device=dev, generator=g)
    values = torch.randn(obj, n, 512, device=dev, generator=g)
    valid = torch.rand(obj, n, device=dev, generator=g) < 0.8
    if prefix is not None:
        valid[:, prefix:] = False
    q = 3.0 * torch.randn(p, 128, device=dev, generator=g)
    return (keys.to(dtype), values.to(dtype), valid.contiguous(),
            q.to(dtype))


def _occ(occ, dev):
    return None if occ is None else torch.tensor([occ], dtype=torch.int32,
                                                 device=dev)


# Valid slots past the bound stay valid (prefix None), so a kernel that
# ignored the bound would disagree with the plain bounded read.
@pytest.mark.parametrize("n,p,chunk,occ,prefix", [
    (1000, 37, 256, None, None),    # ragged N and P, no bound
    (1000, 37, 256, 300, None),     # bound cuts to 2 of 4 chunks
    (1000, 16, 256, 1000, None),    # ragged last chunk padded to 1024
    (640, 1, 128, 0, 0),            # empty bound, all invalid: one chunk
    (20000, 100, 8192, 9000, None),  # the main path's chunk
])
def test_kernels_match_plain(dev, n, p, chunk, occ, prefix):
    keys, values, valid, q = _bank(dev, 2, n, p, seed=n + p,
                                   prefix=prefix)
    occ_t = _occ(occ, dev)
    mem, m, l, log_thres = bank_read_cuda.bank_read(q, keys, values, valid,
                                                    occ_t, chunk)
    torch.testing.assert_close(log_thres, math.log(1e-3) + torch.log(l) + m)
    cnt = bank_read_cuda.bank_count(q, keys, valid, occ_t, log_thres, chunk)
    for o in range(2):
        if occ is None:
            want_mem, want_cnt = attention._read_dense(
                keys[o], values[o], valid[o], q, 1e-3)
        else:
            want_mem, wm, wl = attention._read_occ_sweep(
                keys[o], values[o], valid[o], q, chunk, occ)
            torch.testing.assert_close(m[o], wm, rtol=1e-5, atol=1e-5)
            torch.testing.assert_close(l[o], wl, rtol=1e-4, atol=0)
            want_cnt = attention._count_occ_sweep(
                keys[o], valid[o], q, log_thres[o], chunk, occ)
        torch.testing.assert_close(mem[o], want_mem, rtol=2e-4, atol=2e-5)
        assert (cnt[o] - want_cnt).abs().max().item() <= 1.0


# Segment boundaries: (n, p, chunk, occ, splits). The visited slots are cut
# into ceil(ceil(n_visit / S) / 32) * 32-slot segments.
@pytest.mark.parametrize("n,p,chunk,occ,splits", [
    (640, 37, 128, 0, 8),        # 128 visited: 4 segments of 32, 4 empty
    (1000, 37, 256, 300, 3),     # 512 visited: 192 + 192 + 128
    (1000, 100, 256, 1000, 5),   # 1024 visited, 24 of them padding past N
    (20000, 37, 8192, 20000, 4),  # ragged N: the last segment ends in padding
    (20000, 64, 8192, 9000, 5),  # bound ends inside segment 4 of 5
    (700, 20, 8192, 700, 1),     # N below the chunk: 700 slots, one segment
])
def test_split_partials_and_combine_match_plain(dev, n, p, chunk, occ,
                                                splits):
    keys, values, valid, q = _bank(dev, 2, n, p, seed=7 * n + p)
    occ_t = _occ(occ, dev)
    m_s, l_s, acc_s = bank_read_cuda.bank_read_partials(
        q, keys, values, valid, occ_t, chunk, splits)
    n_visit = attention.visited_slots(n, chunk, occ)
    seg = attention.segment_length(n_visit, splits, bank_read_cuda.READ_TILE)
    for o in range(2):
        wm, wl, wacc = attention._read_occ_segments(
            keys[o], values[o], valid[o], q, chunk, occ, splits)
        for s in range(splits):
            if s * seg >= n_visit:   # an empty segment weighs nothing
                assert (m_s[o, s] == -math.inf).all()
                assert (l_s[o, s] == 0).all() and (acc_s[o, s] == 0).all()
                continue
            torch.testing.assert_close(m_s[o, s], wm[s], rtol=1e-5,
                                       atol=1e-5)
            torch.testing.assert_close(l_s[o, s], wl[s], rtol=1e-4, atol=0)
            torch.testing.assert_close(acc_s[o, s] / l_s[o, s, :, None],
                                       wacc[s] / wl[s, :, None],
                                       rtol=2e-4, atol=2e-5)
    got = bank_read_cuda.bank_read_combine(m_s, l_s, acc_s, 1e-3)
    want = attention.combine_partials(m_s, l_s, acc_s, 1e-3)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
    for o in range(2):
        mem, m, l = attention._read_occ_sweep(keys[o], values[o], valid[o],
                                              q, chunk, occ)
        torch.testing.assert_close(got[0][o], mem, rtol=2e-4, atol=2e-5)
        torch.testing.assert_close(got[1][o], m, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(got[2][o], l, rtol=1e-4, atol=0)


def test_all_invalid_bank(dev):
    keys, values, _, q = _bank(dev, 2, 700, 20, seed=3)
    valid = torch.zeros(2, 700, dtype=torch.bool, device=dev)
    mem, cnt = attention.bank_attention_read(keys, values, valid, q,
                                             occ_bound=700)
    assert torch.isfinite(mem).all() and cnt.sum().item() == 0
    want = attention._read_dense(keys[0], values[0], valid[0], q, 1e-3)[0]
    torch.testing.assert_close(mem[0], want, rtol=2e-4, atol=2e-5)


def test_dispatcher_counts_launches_and_refuses_bad_input(dev):
    keys, values, valid, q = _bank(dev, 2, 512, 24, seed=5)
    bank_read_cuda.reset_launches()
    attention.bank_attention_read(keys, values, valid, q,
                                  occ_bound=torch.tensor(300, device=dev))
    assert bank_read_cuda.launches == {"bank_read": 1,
                                       "bank_read_combine": 1,
                                       "bank_count": 1,
                                       "bank_read_bf16": 0,
                                       "bank_count_bf16": 0}
    with pytest.raises(ValueError):
        attention.bank_attention_read(keys, values, valid, q.double())
    with pytest.raises(ValueError):
        attention.bank_attention_read(keys[:, :, :64].contiguous(),
                                      values, valid, q[:, :64].contiguous())


# bf16 banks: ragged P and N, bounds inside segments, S = 1..MAX_SPLITS and
# all-invalid banks: (n, p, chunk, occ, splits, prefix). Valid slots past
# the bound stay valid unless prefix says otherwise.
@pytest.mark.parametrize("n,p,chunk,occ,splits,prefix", [
    (1000, 37, 256, None, 1, None),    # ragged N and P, no bound, S = 1
    (1000, 37, 256, 300, 3, None),     # 512 visited: 192 + 192 + 128
    (1000, 100, 256, 1000, 5, None),   # 24 padding slots past N
    (640, 1, 128, 0, 8, 0),            # all invalid at occupancy 0, S = 8
    (700, 20, 8192, 700, 2, 0),        # all invalid, N below the chunk
    (20000, 64, 8192, 9000, 5, None),  # bound inside segment 4 of 5
    (20000, 129, 8192, 20000, 4, None),  # ragged N, last segment padded
    (5000, 65, 1024, 4000, 6, None),   # P one past two query tiles
    (3000, 50, 512, 2500, 7, None),
    # all invalid, the visited range (1024) past N = 1000 in both objects:
    # the 24 padding slots must be zeros, not the next object's rows
    (1000, 37, 256, 1000, 5, 0),
    # the main path's shape: P = 1620 at one 8,192-slot chunk, where the
    # count cuts the query tiles across blocks
    (20000, 1620, 8192, 1700, 5, None),
    # 500 visited slots: the last segment ends 52 slots into a 64-slot
    # tile, with valid slots past it
    (1000, 70, 100, 430, 3, None),
])
def test_bf16_kernels_match_plain(dev, n, p, chunk, occ, splits, prefix):
    keys, values, valid, q = _bank(dev, 2, n, p, seed=11 * n + p,
                                   prefix=prefix, dtype=torch.bfloat16)
    occ_t = _occ(occ, dev)
    parts = bank_read_cuda.bank_read_partials(q, keys, values, valid, occ_t,
                                              chunk, splits)
    mem, m, l, log_thres = bank_read_cuda.bank_read_combine(*parts, 1e-3)
    cnt = bank_read_cuda.bank_count(q, keys, valid, occ_t, log_thres, chunk)
    bound = n if occ is None else occ
    n_visit = attention.visited_slots(n, chunk, bound)
    seg = attention.segment_length(n_visit, splits,
                                   bank_read_cuda.read_tile(torch.bfloat16))
    for o in range(2):
        want_mem, wm, wl = attention._read_occ_sweep(
            keys[o], values[o], valid[o], q, chunk, bound)
        torch.testing.assert_close(mem[o], want_mem, rtol=1e-2, atol=2e-3)
        torch.testing.assert_close(m[o], wm, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(l[o], wl, rtol=1e-4, atol=0)
        want_cnt = attention._count_occ_sweep(keys[o], valid[o], q,
                                              log_thres[o], chunk, bound)
        assert (cnt[o] - want_cnt).abs().max().item() <= 1.0
        assert cnt[o, min(n_visit, n):].abs().sum().item() == 0
        if prefix == 0:   # every visited slot, padding included, weighs 1
            assert cnt[o].sum().item() == 0
            want = values[o, :n_visit].float().sum(0) / n_visit
            torch.testing.assert_close(mem[o], want.expand_as(mem[o]),
                                       rtol=1e-2, atol=2e-3)
        wms, wls, waccs = attention._read_occ_segments(
            keys[o], values[o], valid[o], q, chunk, bound, splits)
        for s_ in range(splits):
            if s_ * seg >= n_visit:   # an empty segment weighs nothing
                assert (parts[0][o, s_] == -math.inf).all()
                assert (parts[1][o, s_] == 0).all()
                continue
            torch.testing.assert_close(parts[0][o, s_], wms[s_], rtol=1e-5,
                                       atol=1e-5)
            torch.testing.assert_close(parts[1][o, s_], wls[s_], rtol=1e-4,
                                       atol=0)


def test_bf16_dispatch_counts_launches_and_never_falls_back(dev):
    keys, values, valid, q = _bank(dev, 2, 512, 24, seed=6,
                                   dtype=torch.bfloat16)
    bank_read_cuda.reset_launches()
    mem, cnt = attention.bank_attention_read(
        keys, values, valid, q.float(), occ_bound=torch.tensor(300,
                                                               device=dev))
    assert mem.dtype == torch.bfloat16 and cnt.dtype == torch.float32
    assert bank_read_cuda.launches == {
        "bank_read": 0, "bank_read_combine": 1, "bank_count": 0,
        "bank_read_bf16": 1, "bank_count_bf16": 1}
    with pytest.raises(ValueError):   # mixed bank dtypes
        attention.bank_attention_read(keys, values.float(), valid, q)
    with pytest.raises(ValueError):   # no kernel for float16
        attention.bank_attention_read(keys.half(), values.half(), valid,
                                      q.half())
