"""The bank read with a stream axis: q [B, P, dk] against the banks of B
streams folded along the object axis ([B x obj, N, d]), object o reading
plane o // obj, one occupancy bound for every stream and object.

- The port's stream-axis read (the plain versions on the CPU) equals B
  single-stream reads of the same planes exactly, in float32 and bf16.
- Each stream's mem and counts hold against the JAX package's
  ``bank_attention_read`` of that stream (run on the CPU, as the JAX tests
  run it) with the shared bound, within the bounds of
  tests/test_attention_pallas.py: mem rtol 2e-4 / atol 2e-5, counts within
  1.
- The kernels' wrappers take the folded shapes: the query planes must
  divide the objects, and the split heuristics see B x obj objects.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfloodnet_tpu.ops import bank_attention_read as j_read
from vfloodnet_tpu_torch.ops import attention, bank_attention_read
from vfloodnet_tpu_torch.ops import bank_read_cuda

torch.set_num_threads(2)
MEM_TOL = dict(rtol=2e-4, atol=2e-5)
B, OBJ = 3, 2


def _streams(seed, n, p, occ, dk=16, dv=24):
    """B streams of OBJ objects: each stream's valid slots lie below its
    own occupancy (the largest is ``occ``), q scaled up for a peaked
    softmax with nonzero counts."""
    rng = np.random.RandomState(seed)
    keys = rng.randn(B * OBJ, n, dk).astype(np.float32)
    values = rng.randn(B * OBJ, n, dv).astype(np.float32)
    occs = [occ, occ // 2, occ // 3]
    valid = np.zeros((B * OBJ, n), bool)
    for b, o in enumerate(occs):
        valid[OBJ * b:OBJ * (b + 1), :o] = rng.rand(OBJ, o) < 0.8
    q = (2.0 * rng.randn(B, p, dk)).astype(np.float32)
    return keys, values, valid, q


# n > one 8,192-slot chunk with a bound takes the occupancy-bounded read,
# the main path's; the small bank takes the dense read
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n,p,occ", [(9000, 40, 8500), (300, 50, 300)],
                         ids=["occ", "dense"])
def test_stream_read_equals_per_stream_reads(dtype, n, p, occ):
    keys, values, valid, q = (torch.from_numpy(a) for a in
                              _streams(0, n, p, occ))
    keys, values = keys.to(dtype), values.to(dtype)
    bound = torch.tensor(occ, dtype=torch.int32)
    mem, cnt = bank_attention_read(keys, values, valid, q, occ_bound=bound)
    assert mem.shape == (B * OBJ, p, values.shape[-1])
    assert mem.dtype == dtype and cnt.shape == (B * OBJ, n)
    for b in range(B):
        rows = slice(OBJ * b, OBJ * (b + 1))
        want = bank_attention_read(keys[rows], values[rows], valid[rows],
                                   q[b], occ_bound=bound)
        assert torch.equal(mem[rows], want[0]) and torch.equal(cnt[rows],
                                                               want[1])
    assert cnt.sum() > 0


def test_stream_read_matches_jax_per_stream():
    n, p, occ = 9000, 40, 8500
    keys, values, valid, q = _streams(1, n, p, occ)
    mem, cnt = bank_attention_read(*(torch.from_numpy(a) for a in
                                     (keys, values, valid, q)),
                                   occ_bound=torch.tensor(occ))
    for o in range(B * OBJ):
        want_mem, want_cnt = j_read(
            *(jnp.asarray(a[o]) for a in (keys, values, valid)),
            jnp.asarray(q[o // OBJ]), occ_bound=jnp.int32(occ))
        np.testing.assert_allclose(mem[o].numpy(), np.asarray(want_mem),
                                   **MEM_TOL)
        np.testing.assert_allclose(cnt[o].numpy(), np.asarray(want_cnt),
                                   atol=1.0)
        assert np.asarray(want_cnt).sum() > 0


def test_stream_axis_shapes_and_split_heuristics():
    q = torch.zeros(3, 5, 128)
    q[2] = 1.0
    assert torch.equal(attention.query_plane(q, 5, 6), q[2])
    assert torch.equal(attention.query_plane(q[:1], 4, 6), q[0])
    one = q[0]
    assert attention.query_plane(one, 3, 6) is one
    with pytest.raises(ValueError, match="divide"):
        attention.query_plane(q, 0, 4)
    with pytest.raises(ValueError, match="dividing"):
        bank_read_cuda._query_planes(q, 4)
    assert bank_read_cuda._query_planes(q, 6) == 3
    assert bank_read_cuda._query_planes(q[0], 6) == 1
    # the read's segments: 8 objects (4 streams of 2) x 26 query tiles of
    # P = 1620 on 132 SMs keep S = 5, as 2 objects do
    assert bank_read_cuda.default_splits(2, 1620, 132) == 5
    assert bank_read_cuda.default_splits(8, 1620, 132) == 5
    # the bf16 count at one 8,192-slot chunk: 8 x 16 slot tiles of 512
    # take 2 query-tile shares (2 objects' 32 tiles took 8)
    assert bank_read_cuda.count_splits(32, 26, 132) == 8
    assert bank_read_cuda.count_splits(128, 26, 132) == 2
