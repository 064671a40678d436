"""The port's mesh and sharded bank read (``vfloodnet_tpu_torch.parallel``)
on worlds of 2 and 4 gloo ranks, against the JAX package's
``sharded_bank_attention_read`` on meshes of 2 and 4 of conftest's CPU
devices, from the same numpy inputs (tests/test_parallel.py's sizes).

Three objects in one bank: valid slots at random, valid slots only in the
first 20 (every other shard empty), and none at all. float32: mem rtol
1e-4 / atol 1e-5 and equal counts (tests/test_parallel.py); when no shard
holds a valid slot, mem is 0 as in JAX. The bank rounded to bf16 against
JAX's float32 read of the same rounded numbers: mem rtol 1e-2 / atol
2e-3, counts within 1 (the bf16 bars of tests/test_torch_bf16_ops.py).
Each world size is one spawn that runs every case (``torch_parallel_
ranks.py``); the JAX side runs here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parallel_ranks import mesh_rank, read_rank, spawn
from vfloodnet_tpu.parallel import make_mesh as j_make_mesh
from vfloodnet_tpu.parallel import sharded_bank_attention_read as j_read
from vfloodnet_tpu_torch.memory import FeatureBank
from vfloodnet_tpu_torch.parallel import (Mesh, close_world,
                                          init_local_world, make_mesh,
                                          shard_bank_state)

N, DK, DV, P, OBJ = 512, 16, 24, 40, 3
WORLDS = (2, 4)


def _inputs():
    rng = np.random.RandomState(0)
    keys = rng.randn(OBJ, N, DK).astype(np.float32)
    values = rng.randn(OBJ, N, DV).astype(np.float32)
    valid = np.zeros((OBJ, N), bool)
    valid[0] = rng.rand(N) > 0.3
    valid[1, :20] = True                  # every shard but the first empty
    q = (3.0 * rng.randn(P, DK)).astype(np.float32)   # a peaked softmax
    return keys, values, valid, q


def _bf16(x):
    return np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    """{world: (JAX float32, JAX on the bf16-rounded numbers, the port's
    per-rank results)}."""
    keys, values, valid, q = _inputs()
    tmp = tmp_path_factory.mktemp("read")
    path = str(tmp / "read.npz")
    np.savez(path, keys=keys, values=values, valid=valid, q=q)
    waits = {world: spawn(read_rank, world, tmp, path, wait=False)
             for world in WORLDS}
    out = {}
    for world in WORLDS:
        mesh = j_make_mesh((1, world), devices=jax.devices()[:world])
        read = jax.jit(lambda *a, mesh=mesh: j_read(mesh, *a))
        ref = {}
        for name, cast in (("f32", lambda x: x), ("bf16", _bf16)):
            res = [read(jnp.asarray(cast(keys[o])),
                        jnp.asarray(cast(values[o])), jnp.asarray(valid[o]),
                        jnp.asarray(cast(q))) for o in range(OBJ)]
            ref[name] = (np.stack([np.asarray(r[0]) for r in res]),
                         np.stack([np.asarray(r[1]) for r in res]))
        out[world] = (ref, waits[world]())
    return out


def _port(ranks, name):
    """(mem of rank 0, every rank's mem, counts of the whole bank)."""
    mems = [r[name][0] for r in ranks]
    return mems[0], mems, np.concatenate([r[name][1] for r in ranks],
                                         axis=1)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_read_matches_jax(reads, world):
    ref, ranks = reads[world]
    mem, mems, cnt = _port(ranks, "f32")
    for other in mems[1:]:
        np.testing.assert_array_equal(other, mem)   # replicated
    np.testing.assert_allclose(mem[0], ref["f32"][0][0], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(cnt[0], ref["f32"][1][0], atol=1e-3)
    assert cnt[0].sum() > 0


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_read_with_empty_shards(reads, world):
    ref, ranks = reads[world]
    mem, _, cnt = _port(ranks, "f32")
    assert np.isfinite(mem).all()
    np.testing.assert_allclose(mem[1], ref["f32"][0][1], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(cnt[1], ref["f32"][1][1], atol=1e-3)
    assert cnt[1, 20:].sum() == 0.0


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_read_all_shards_empty(reads, world):
    """No shard holds a valid slot: JAX visits nothing and gives 0; the
    port's read visits a chunk of invalid slots on every shard, which the
    combine must drop."""
    ref, ranks = reads[world]
    mem, _, cnt = _port(ranks, "f32")
    np.testing.assert_array_equal(ref["f32"][0][2], 0.0)
    np.testing.assert_array_equal(mem[2], 0.0)
    np.testing.assert_array_equal(cnt[2], 0.0)


def test_sharded_read_bf16_bank(reads):
    ref, ranks = reads[2]
    mem, mems, cnt = _port(ranks, "bf16")
    np.testing.assert_array_equal(mems[1], mem)
    for o in range(OBJ):
        np.testing.assert_allclose(mem[o], ref["bf16"][0][o], rtol=1e-2,
                                   atol=2e-3)
        np.testing.assert_allclose(cnt[o], ref["bf16"][1][o], atol=1.0)
    assert cnt[0].sum() > 0


def test_mesh_layouts(tmp_path):
    """A world of 4 laid out (4, 1), (2, 2) and (1, 4), row-major as
    ``np.reshape`` lays JAX's devices; the groups hold the right ranks;
    a shape of another size raises, in a world of 4 and in the in-process
    world of one."""
    ranks = spawn(mesh_rank, 4, tmp_path)
    for rank, res in enumerate(ranks):
        assert res["bad"]
        for shape, (d, m) in ((None, (4, 1)), ((2, 2), (2, 2)),
                              ((1, 4), (1, 4))):
            got_shape, coords, (model_sum, data_sum) = res[shape]
            assert got_shape == (d, m)
            layout = np.arange(4).reshape(d, m)
            assert coords == tuple(int(c[0]) for c in
                                   np.nonzero(layout == rank))
            assert model_sum == layout[coords[0], :].sum()
            assert data_sum == layout[:, coords[1]].sum()
    init_local_world("cpu")
    try:
        mesh = make_mesh()
        assert mesh.shape == (1, 1) and mesh.coords == (0, 0)
        assert mesh.device == torch.device("cpu")
        with pytest.raises(ValueError):
            make_mesh((2, 1))
    finally:
        close_world()


def test_shard_bank_state():
    """Each of 4 model ranks keeps its slice of the capacity axis, the
    slices in rank order make the bank, and the totals stay whole; a
    capacity that does not split raises."""
    fb = FeatureBank(obj_n=2, memory_budget=2048, device="cpu")
    rng = np.random.RandomState(1)
    state = fb.init_bank(torch.from_numpy(rng.randn(2, 100, 128).astype(
        np.float32)), torch.from_numpy(rng.randn(2, 100, 512).astype(
            np.float32)))
    layout = np.arange(4).reshape(1, 4)
    parts = [shard_bank_state(Mesh((1, 4), r, (0, r), layout, (None, None),
                                   torch.device("cpu")), state)
             for r in range(4)]
    for k in ("keys", "values", "valid", "birth", "usage"):
        whole = torch.cat([getattr(p, k) for p in parts], dim=1)
        torch.testing.assert_close(whole, getattr(state, k), rtol=0, atol=0)
    for p in parts:
        for k in ("occ", "peak_n", "replace_n"):
            torch.testing.assert_close(getattr(p, k), getattr(state, k),
                                       rtol=0, atol=0)
    with pytest.raises(ValueError):
        shard_bank_state(Mesh((1, 3), 0, (0, 0),
                              np.arange(3).reshape(1, 3), (None, None),
                              torch.device("cpu")), state)
