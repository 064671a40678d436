"""The bf16 bank kernels' tiling, on the CPU (nothing is compiled here):
the read's per-dtype slot tile and its segments, the count's choice of
query-tile shares, and the plain version of the bf16 read's partials at the
bf16 tile, merged, against the JAX package's ``_xla_read_occ``.

Bars against ``_xla_read_occ``, which keeps its scores in bf16 where the
port's are float32: those of tests/test_bank_ops.py (mean relative error of
mem < 0.05, mean count difference < 2), as in tests/test_torch_bf16_ops.py.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfloodnet_tpu.ops.attention import _xla_read_occ
from vfloodnet_tpu_torch.ops import attention, bank_read_cuda

BF = torch.bfloat16


def test_read_tile_per_dtype_sets_the_plain_segments():
    assert bank_read_cuda.read_tile(torch.float32) == 32
    assert bank_read_cuda.read_tile(BF) == 64
    # main path: 8,192 visited slots in 5 segments of whole 64-slot tiles
    assert attention.segment_length(8192, 5, 64) == 1664
    assert attention.segment_length(16384, 5, 64) == 3328
    # 200 visited slots in 8 segments: 32-slot segments in float32 (7 of
    # them hold slots), 64-slot ones in bf16 (4 of them)
    rng = np.random.RandomState(3)
    n, dk, dv = 200, 16, 8
    keys = torch.from_numpy(rng.randn(n, dk).astype(np.float32))
    values = torch.from_numpy(rng.randn(n, dv).astype(np.float32))
    valid = torch.ones(n, dtype=torch.bool)
    q = torch.from_numpy(rng.randn(5, dk).astype(np.float32))
    for dtype, filled in ((torch.float32, 7), (BF, 4)):
        m_s, l_s, _ = attention._read_occ_segments(
            keys.to(dtype), values.to(dtype), valid, q.to(dtype), 256, n, 8)
        empty = (m_s == -math.inf).all(dim=1)
        assert empty.tolist() == [False] * filled + [True] * (8 - filled)
        assert (l_s[filled:] == 0).all()


def test_count_splits_fill_the_card():
    sms, q_tiles = 132, -(-1620 // bank_read_cuda.QUERY_TILE)   # 26
    tile = bank_read_cuda.COUNT_TILE_BF16
    # one 8,192-slot chunk of 2 objects: 32 slot tiles
    slot_tiles = 2 * -(-8192 // tile)
    s = bank_read_cuda.count_splits(slot_tiles, q_tiles, sms)
    assert s == 8 and slot_tiles * s >= sms
    # the full bank already fills the card: no split
    assert bank_read_cuda.count_splits(2 * 98304 // tile, q_tiles, sms) == 1
    # P = 1: one query tile, nothing to split
    assert bank_read_cuda.count_splits(slot_tiles, 1, sms) == 1
    # N below one tile: each object one slot tile, every query tile a share
    assert bank_read_cuda.count_splits(2, q_tiles, sms) == q_tiles


def test_count_splits_bounds():
    for slot_tiles in (1, 2, 7, 32, 64, 131, 132, 400):
        for q_tiles in (1, 5, 26, 1023, 1024, 3000):
            s = bank_read_cuda.count_splits(slot_tiles, q_tiles, 132)
            # every share holds a query tile, and at most COUNT_MAX_QTILES
            assert 1 <= s <= q_tiles
            assert -(-q_tiles // s) <= bank_read_cuda.COUNT_MAX_QTILES
            if slot_tiles < 132 and q_tiles >= -(-132 // slot_tiles):
                assert slot_tiles * s >= 132


@pytest.mark.parametrize("occ,splits", [(1500, 5), (2000, 3)])
def test_bf16_segments_merged_match_xla_read_occ(occ, splits):
    rng = np.random.RandomState(occ + splits)
    n, dk, dv, p, chunk = 2000, 16, 24, 40, 512
    jk = jnp.asarray(rng.randn(n, dk).astype(np.float32), jnp.bfloat16)
    jv = jnp.asarray(rng.randn(n, dv).astype(np.float32), jnp.bfloat16)
    valid = rng.rand(n) < 0.8
    q = (2.0 * rng.randn(p, dk)).astype(np.float32)
    tk, tv = (torch.from_numpy(np.asarray(a, np.float32)).to(BF)
              for a in (jk, jv))
    tq, tok = torch.from_numpy(q).to(BF), torch.from_numpy(valid)
    parts = attention._read_occ_segments(tk, tv, tok, tq, chunk, occ,
                                         splits)
    mem, m, l, log_thres = attention.combine_partials(*parts, 1e-3)
    cnt = attention._count_occ_sweep(tk, tok, tq, log_thres, chunk, occ)
    want_mem, want_cnt = _xla_read_occ(jk, jv, jnp.asarray(valid),
                                       jnp.asarray(q), 1e-3, chunk,
                                       jnp.int32(occ))
    want = np.asarray(want_mem, np.float32)
    err = np.abs(mem.to(BF).float().numpy() - want)
    assert err.mean() / np.abs(want).mean() < 0.05
    assert np.abs(cnt.numpy() - np.asarray(want_cnt)).mean() < 2.0
    assert cnt.sum() > 0
