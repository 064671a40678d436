"""The port's sharded bank update (``parallel/sharded_update.py``) on
worlds of 2 and 4 gloo ranks against the JAX package's
``sharded_bank_merge_append`` on a mesh of 2 of conftest's CPU devices,
one jitted call for both banks (their shapes are equal). The JAX update's
result does not depend on the number of shards (free slots go first in
global slot order, and LFU ties to the lower global slot, because the
gathered candidates are rank-major), so the world of 4 is held to it too.

Two banks, updated as two objects of one port call:

- ``append``: 120 valid slots of 256, usage at random, a quarter of the
  new features near-copies of slots (merged), the rest appended: 8 fill
  the first shard's free slots, the rest go on to the next shard. Slot 5's
  key is also at slot 130, on another shard, so the best match ties
  across shards and the lower rank must own the merge.
- ``evict``: every slot valid but 10 scattered ones, usage in 5 steps
  (ties across shards): appends take the free slots first, then the
  lowest usage / age, ties to the lower slot.

Victims, ``birth``, ``usage``, ``valid`` and ``evicted_n`` equal slot for
slot; keys and values within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_parallel_ranks import spawn, update_rank
from vfloodnet_tpu.parallel import make_mesh as j_make_mesh
from vfloodnet_tpu.parallel.sharded_update import \
    sharded_bank_merge_append as j_update

N, DK, DV, M, FRAME = 256, 16, 24, 32, 10.0
CASES = ("append", "evict")


def _banks():
    rng = np.random.RandomState(0)
    keys = rng.randn(2, N, DK).astype(np.float32)
    values = rng.randn(2, N, DV).astype(np.float32)
    valid = np.zeros((2, N), bool)
    birth = np.zeros((2, N), np.float32)
    usage = np.zeros((2, N), np.float32)
    valid[0, :120] = True
    valid[0, 130] = True
    keys[0, 130] = keys[0, 5]
    values[0, 130] = values[0, 5]
    usage[0] = np.where(valid[0], rng.rand(N).astype(np.float32) * 5, 0.0)
    valid[1] = True
    valid[1, rng.choice(N, 10, replace=False)] = False
    usage[1] = np.where(valid[1], np.floor(np.linspace(1, 5.99, N)), 0.0)
    birth[1] = rng.randint(0, 3, N).astype(np.float32)
    new_keys = rng.randn(2, M, DK).astype(np.float32)
    new_keys[0, :M // 4] = keys[0, :M // 4] * 1.7 + 0.001 * rng.randn(
        M // 4, DK)
    new_keys[0, 0] = keys[0, 5] * 1.3         # ties slots 5 and 130
    new_keys[1] *= 0.01                       # nothing merges: appends
    new_values = rng.randn(2, M, DV).astype(np.float32)
    return dict(keys=keys, values=values, valid=valid, birth=birth,
                usage=usage, new_keys=new_keys, new_values=new_values,
                frame_idx=np.float32(FRAME))


@pytest.fixture(scope="module")
def updates(tmp_path_factory):
    data = _banks()
    tmp = tmp_path_factory.mktemp("update")
    path = str(tmp / "bank.npz")
    np.savez(path, **data)
    waits = {world: spawn(update_rank, world, tmp, path, wait=False)
             for world in (2, 4)}
    mesh = j_make_mesh((1, 2), devices=jax.devices()[:2])
    update = jax.jit(lambda *a: j_update(mesh, *a, FRAME))
    ref = {}
    for o, case in enumerate(CASES):
        out = update(*(jnp.asarray(data[k][o]) for k in (
            "keys", "values", "valid", "birth", "usage", "new_keys",
            "new_values")))
        ref[case] = dict(zip(("keys", "values", "valid", "birth", "usage",
                              "evicted"), (np.asarray(x) for x in out)))
    port = {}
    for world, wait in waits.items():
        ranks = wait()
        bank = {k: np.concatenate([r[0][k] for r in ranks], axis=1)
                for k in ranks[0][0]}
        port[world] = (bank, [r[1] for r in ranks])
    return data, ref, port


@pytest.mark.parametrize("world", (2, 4))
@pytest.mark.parametrize("case", CASES)
def test_sharded_update_matches_jax(updates, case, world):
    data, ref, port = updates
    o = CASES.index(case)
    bank, evicted = port[world]
    want = ref[case]
    for k in ("valid", "birth", "usage"):
        np.testing.assert_array_equal(bank[k][o], want[k], err_msg=k)
    for k in ("keys", "values"):
        np.testing.assert_allclose(bank[k][o], want[k], rtol=0, atol=1e-6,
                                   err_msg=k)
    for ev in evicted:                       # replicated
        assert int(ev[o]) == int(want["evicted"])


def test_sharded_update_cases_do_what_they_claim(updates):
    """The banks exercise what the file's note says: merges (one of them
    owned across a cross-shard tie), appends into two shards, and free
    slots taken before LFU victims."""
    data, ref, _ = updates
    new = ref["append"]["birth"] == FRAME
    assert new[:128].sum() == 8 and new[128:].sum() > 0
    assert not np.allclose(ref["append"]["keys"][5], data["keys"][0, 5])
    np.testing.assert_array_equal(ref["append"]["keys"][130],
                                  data["keys"][0, 130])
    free = ~data["valid"][1]
    taken = ref["evict"]["birth"] == FRAME
    assert taken[free].all() and taken.sum() == M
    assert int(ref["evict"]["evicted"]) == M - free.sum()
