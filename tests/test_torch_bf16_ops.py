"""The bf16 configuration's bank read and resize: the port against the
JAX package on the CPU, from the same numpy inputs.

- The plain bf16 read and count against ``pallas_bank_read`` on bf16 banks
  in interpret mode: mem rtol 1e-2 / atol 2e-3 (one bf16 ulp is 3.9e-3
  relative, and mem is rounded to bf16 by both), counts within 1. Against
  the JAX engine's ``_xla_read_occ``, which keeps its scores in bf16 where
  the port's are float32: the bars of tests/test_bank_ops.py (mean relative
  error < 0.05, mean count difference < 2).
- The bf16 bicubic resize is bitwise the JAX package's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vfloodnet_tpu.ops.attention import _xla_read_occ
from vfloodnet_tpu.ops.attention_pallas import pallas_bank_read
from vfloodnet_tpu.ops.resize import resize as j_resize
from vfloodnet_tpu_torch.ops import attention
from vfloodnet_tpu_torch.ops.resize import resize

BF = torch.bfloat16


def _bf(x):
    """A numpy float32 array rounded to bf16 (as JAX rounds it), as the
    JAX array and as the torch tensor."""
    j = jnp.asarray(x, jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j, np.float32)).to(BF)


@pytest.mark.parametrize("n,p", [(512, 40), (1000, 30)])
def test_plain_bf16_read_matches_pallas(n, p):
    rng = np.random.RandomState(0)
    dk, dv = 16, 32
    jk, tk = _bf(rng.randn(n, dk).astype(np.float32))
    jv, tv = _bf(rng.randn(n, dv).astype(np.float32))
    valid = rng.rand(n) > 0.25
    q = (3.0 * rng.randn(p, dk)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        mem_p, cnt_p = pallas_bank_read(jk, jv, jnp.asarray(valid),
                                        jnp.asarray(q), thres=1e-3,
                                        chunk=256)
    mem, cnt = attention.bank_attention_read(
        tk[None], tv[None], torch.from_numpy(valid)[None],
        torch.from_numpy(q))
    assert mem.dtype == BF and cnt.dtype == torch.float32
    np.testing.assert_allclose(mem[0].float().numpy(),
                               np.asarray(mem_p, np.float32),
                               rtol=1e-2, atol=2e-3)
    np.testing.assert_allclose(cnt[0].numpy(), np.asarray(cnt_p), atol=1.0)
    assert cnt.sum() > 0


def test_plain_bf16_occ_read_close_to_xla_read_occ():
    rng = np.random.RandomState(7)
    n, dk, dv, p_n, occ = 20000, 16, 24, 40, 9000
    jk, tk = _bf(rng.randn(n, dk).astype(np.float32))
    jv, tv = _bf(rng.randn(n, dv).astype(np.float32))
    valid = np.arange(n) < occ
    q = rng.randn(p_n, dk).astype(np.float32)
    m16, c16 = _xla_read_occ(jk, jv, jnp.asarray(valid), jnp.asarray(q),
                             1e-3, 8192, jnp.int32(occ))
    mem, cnt = attention.bank_attention_read(
        tk[None], tv[None], torch.from_numpy(valid)[None],
        torch.from_numpy(q), occ_bound=occ)
    want = np.asarray(m16, np.float32)
    err = np.abs(mem[0].float().numpy() - want)
    assert err.mean() / np.abs(want).mean() < 0.05
    assert np.abs(cnt[0].numpy() - np.asarray(c16)).mean() < 2.0


def test_bf16_bicubic_is_the_jax_resize():
    rng = np.random.RandomState(11)
    x = rng.rand(60, 90, 3).astype(np.float32)
    jx, tx = _bf(x)
    for out_hw in ((40, 71), (120, 181)):
        want = np.asarray(j_resize(jx, out_hw, "bicubic"), np.float32)
        got = resize(tx, out_hw, "bicubic")
        assert got.dtype == BF
        np.testing.assert_array_equal(got.float().numpy(), want)
