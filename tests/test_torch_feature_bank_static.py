"""The port's ``FeatureBank`` transitions against the JAX package's, on
the same numpy inputs: ``update`` through capacity (with a loose
occupancy bound on every other frame, which must change nothing) and
``append`` with many equal LFU priorities (keys compared slot by slot, so
victims taken in another order than JAX's ``top_k`` fail), plus the
pieces that keep the update free of host syncs: the victims' order, the
scatter that drops rows without a boolean index, and the host occupancy
bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vfloodnet_tpu.memory import FeatureBank as JFeatureBank
from vfloodnet_tpu_torch.memory import FeatureBank
from vfloodnet_tpu_torch.memory.feature_bank import OccupancyBound
from vfloodnet_tpu_torch.ops import bank_update

torch.set_num_threads(2)


def test_feature_bank_update_matches_jax_through_capacity():
    rng = np.random.RandomState(21)
    obj_n, dk, dv, p = 2, 8, 8, 96
    jfb = JFeatureBank(obj_n, memory_budget=640, keydim=dk, valdim=dv)
    tfb = FeatureBank(obj_n, memory_budget=640, keydim=dk, valdim=dv,
                      device="cpu")
    k0 = rng.randn(obj_n, p, dk).astype(np.float32)
    v0 = rng.randn(obj_n, p, dv).astype(np.float32)
    js = jfb.init_bank(jnp.asarray(k0), jnp.asarray(v0))
    ts = tfb.init_bank(torch.tensor(k0), torch.tensor(v0))
    keys_buf = ts.keys
    for frame in range(1, 6):
        cnt = rng.randint(0, 3, (obj_n, tfb.class_budget)).astype(np.float32)
        js = jfb.record_usage(js, jnp.asarray(cnt))
        ts = tfb.record_usage(ts, torch.tensor(cnt))
        nk = rng.randn(obj_n, p, dk).astype(np.float32)
        nv = rng.randn(obj_n, p, dv).astype(np.float32)
        nk[:, :10] = np.asarray(js.keys)[:, 5:15] * 3.0     # some merge
        js = jfb.update(js, jnp.asarray(nk), jnp.asarray(nv), frame)
        ts.occ_host.bound = tfb.class_budget if frame % 2 else \
            ts.occ_host.bound                               # loose bound
        ts = tfb.update(ts, torch.tensor(nk), torch.tensor(nv), frame)
        for name in ("keys", "values", "valid", "birth", "usage", "occ",
                     "peak_n", "replace_n"):
            np.testing.assert_allclose(
                getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                atol=1e-5, err_msg=f"{name} at frame {frame}")
        assert ts.occ_host.bound >= int(ts.occ.max())
    assert ts.keys is keys_buf           # updated in place
    assert int(ts.replace_n.sum()) > 0


def test_feature_bank_append_matches_jax_with_ties():
    rng = np.random.RandomState(19)
    jfb = JFeatureBank(obj_n=2, memory_budget=1024, keydim=8, valdim=8)
    tfb = FeatureBank(obj_n=2, memory_budget=1024, keydim=8, valdim=8,
                      device="cpu")
    k0 = rng.randn(2, 500, 8).astype(np.float32)
    v0 = rng.randn(2, 500, 8).astype(np.float32)
    js = jfb.init_bank(jnp.asarray(k0), jnp.asarray(v0))
    ts = tfb.init_bank(torch.tensor(k0), torch.tensor(v0))
    cnt = (rng.rand(2, 512) < 0.3).astype(np.float32)   # many equal usages
    js = jfb.record_usage(js, jnp.asarray(cnt))
    ts = tfb.record_usage(ts, torch.tensor(cnt))
    for frame, m in ((3.0, 8), (4.0, 16), (5.0, 40)):   # then it evicts
        k1 = rng.randn(2, m, 8).astype(np.float32)
        v1 = rng.randn(2, m, 8).astype(np.float32)
        js = jfb.append(js, jnp.asarray(k1), jnp.asarray(v1), frame_idx=frame)
        ts = tfb.append(ts, torch.tensor(k1), torch.tensor(v1),
                        frame_idx=frame)
        for name in ("keys", "values", "valid", "birth", "usage", "occ",
                     "peak_n"):
            np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                          np.asarray(getattr(js, name)))


def test_lfu_victims_follow_jax_top_k_order():
    rng = np.random.RandomState(3)
    prio = rng.randint(0, 4, 300).astype(np.float32) / 3.0
    prio[::7] = 1e30
    prio[5] = 0.0
    got = bank_update.lfu_victims(torch.tensor(prio), 50).numpy()
    _, want = jax.lax.top_k(-jnp.asarray(prio), 50)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_scatter_rows_writes_only_kept_rows():
    bank = torch.arange(20, dtype=torch.float32).reshape(10, 2)
    flags = torch.zeros(10, dtype=torch.bool)
    rows = -torch.ones(4, 2)
    dest = torch.tensor([3, 7, 10, 1])
    bank_update.scatter_rows(dest, torch.tensor([False, True, False, True]),
                             ((bank, rows), (flags, True)))
    want = torch.arange(20, dtype=torch.float32).reshape(10, 2)
    want[[7, 1]] = -1.0
    assert torch.equal(bank, want)
    assert flags.nonzero().flatten().tolist() == [1, 7]
    bank_update.scatter_rows(dest, torch.zeros(4, dtype=torch.bool),
                             ((bank, rows * 5), (flags, True)))
    assert torch.equal(bank, want) and flags.sum() == 2


def test_occupancy_bound_stays_above_occ():
    bound = OccupancyBound(100, capacity=500)
    bound.grow(300)
    assert bound.bound == 400
    bound.grow(300)
    assert bound.bound == 500
    bound.refresh(torch.tensor([120, 90], dtype=torch.int32))   # CPU: exact
    assert bound.bound == 120
    fb = FeatureBank(2, memory_budget=640, keydim=8, valdim=8, device="cpu")
    state = fb.empty()
    assert fb.plan(state, 96) == (1, False)
    state.occ_host.bound = 200
    assert fb.plan(state, 96) == (1, True)
