"""The port's waterline scans against ``vfloodnet_tpu.ops.waterline`` on
the same seeded masks: ``waterline_scan``, ``waterline_below`` and the
batched scan of T (column, start row) pairs against ``jax.vmap`` of
``waterline_below``, as ``StreamingWaterLevel`` builds it. Equal, including
columns with no water, start rows on the last row and past it, and column
indices that are negative or past the mask (JAX's gather wraps a negative
index once and clamps)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfloodnet_tpu.ops.waterline import waterline_below as jbelow
from vfloodnet_tpu.ops.waterline import waterline_scan as jscan
from vfloodnet_tpu_torch.ops.waterline import (waterline_below,
                                               waterline_below_batch,
                                               waterline_scan)


def _masks(seed, h=37, w=29):
    """Label maps with labels 0-2, water (1) from a random row down in
    most columns, a column of no water and a column all water."""
    rng = np.random.RandomState(seed)
    m = rng.randint(0, 3, (h, w)).astype(np.uint8)
    first = rng.randint(0, h + 1, w)
    m[np.arange(h)[:, None] >= first[None, :]] = 1
    m[:, 3] = 0
    m[:, 5] = 1
    m[:, 7] = 2
    m[h - 1, 9] = 1             # water on the last row only
    return m


@pytest.mark.parametrize("seed", [0, 1])
def test_waterline_scan_matches_jax(seed):
    m = _masks(seed)
    for label in (1, 2):
        want = np.asarray(jscan(jnp.asarray(m), water_label=label))
        got = waterline_scan(torch.from_numpy(m), water_label=label)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    assert waterline_scan(torch.from_numpy(m))[3] == m.shape[0]


def test_waterline_below_matches_jax():
    m = _masks(2)
    h, w = m.shape
    jm, tm = jnp.asarray(m), torch.from_numpy(m)
    cases = [(c, r) for c in (0, 3, 5, 7, 9, w - 1, -1, -w, -w - 4, w, w + 9)
             for r in (-1, 0, 5, h - 2, h - 1, h)]
    for c, r in cases:
        want = int(jbelow(jm, jnp.int32(c), jnp.int32(r)))
        got = waterline_below(tm, c, r)
        assert got.dim() == 0 and int(got) == want, (c, r, int(got), want)
    # start row on the last row: nothing strictly below it
    assert int(waterline_below(tm, 9, h - 1)) == h
    assert int(waterline_below(tm, 9, h - 2)) == h - 1


def test_batched_scan_matches_vmapped_jax():
    m = _masks(3, h=48, w=64)
    rng = np.random.RandomState(4)
    cols = np.concatenate([rng.randint(-70, 70, 40), [3, 5, 9, 63, -1]])
    rows = np.concatenate([rng.randint(-2, 50, 40), [0, 47, 46, 48, 47]])
    vmapped = jax.jit(jax.vmap(
        lambda c, r: jbelow(jnp.asarray(m), c, r, water_label=1)))
    want = np.asarray(vmapped(jnp.asarray(cols, jnp.int32),
                              jnp.asarray(rows, jnp.int32)))
    got = waterline_below_batch(
        torch.from_numpy(m), torch.from_numpy(cols.astype(np.int32)),
        torch.from_numpy(rows.astype(np.int32)), water_label=1)
    assert got.dtype == torch.int32 and got.shape == (len(cols),)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == 48).any() and (want < 48).any()
