"""The sharded bank on the card, on a world of one rank over NCCL made in
the test process (``parallel.init_local_world``). Marked ``cuda``; each
test skips where there is no GPU. Run on a GPU machine with ``python -m
pytest --noconftest -m cuda tests/test_torch_sharded_cuda.py``.

- The sharded read of a seeded bank (float32 and bf16) launches the read,
  combine and count kernels once each and equals the single-device read
  on the same bank (the same kernels, bound and segments: mem within 1e-6
  relative, counts equal).
- The sharded update of a full bank equals the single-device update from
  the same bank and features: keys and values within 1e-6, valid, birth,
  usage equal, evictions equal.
"""

import numpy as np
import pytest
import torch

from vfloodnet_tpu_torch.ops import attention, bank_read_cuda, bank_update
from vfloodnet_tpu_torch.parallel import (close_world, init_local_world,
                                          make_mesh,
                                          sharded_bank_attention_read,
                                          sharded_bank_merge_append)

pytestmark = pytest.mark.cuda
OBJ, N, P = 2, 20000, 300


@pytest.fixture
def mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    init_local_world("cuda")
    try:
        yield make_mesh((1, 1))
    finally:
        close_world()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_sharded_read_launches_the_kernels(mesh, dtype):
    dev = mesh.device
    g = torch.Generator(device=dev).manual_seed(0)
    keys = torch.randn(OBJ, N, 128, device=dev, generator=g).to(dtype)
    values = torch.randn(OBJ, N, 512, device=dev, generator=g).to(dtype)
    valid = torch.arange(N, device=dev)[None].expand(OBJ, N) < 9000
    valid = valid.contiguous()
    q = 3.0 * torch.randn(P, 128, device=dev, generator=g)
    bank_read_cuda.reset_launches()
    mem, cnt = sharded_bank_attention_read(mesh, keys, values, valid, q)
    suffix = "" if dtype == torch.float32 else "_bf16"
    launched = {k: v for k, v in bank_read_cuda.launches.items() if v}
    assert launched == {f"bank_read{suffix}": 1, "bank_read_combine": 1,
                        f"bank_count{suffix}": 1}, launched
    want_mem, want_cnt = attention.bank_attention_read(
        keys, values, valid, q, occ_bound=torch.tensor(9000, device=dev))
    torch.testing.assert_close(mem.float(), want_mem.float(), rtol=1e-6,
                               atol=1e-6)
    torch.testing.assert_close(cnt, want_cnt, rtol=0, atol=0)
    assert cnt.sum() > 0


def test_sharded_update_equals_the_single_update(mesh):
    dev = mesh.device
    g = torch.Generator(device=dev).manual_seed(1)
    n, m = 4096, 256
    bank = dict(keys=torch.randn(OBJ, n, 128, device=dev, generator=g),
                values=torch.randn(OBJ, n, 512, device=dev, generator=g),
                valid=torch.ones(OBJ, n, dtype=torch.bool, device=dev),
                birth=torch.zeros(OBJ, n, device=dev),
                usage=torch.rand(OBJ, n, device=dev, generator=g) * 5)
    nk = torch.randn(OBJ, m, 128, device=dev, generator=g)
    nk[:, :64] = bank["keys"][:, :64] * 1.5     # merged
    nv = torch.randn(OBJ, m, 512, device=dev, generator=g)
    single = {k: v.clone() for k, v in bank.items()}
    _, stats = bank_update.bank_merge_append(
        single["keys"], single["values"], single["valid"], single["birth"],
        single["usage"], nk, nv, 7.0,
        torch.full((OBJ,), n, dtype=torch.int32, device=dev), n)
    evicted = sharded_bank_merge_append(
        mesh, bank["keys"], bank["values"], bank["valid"], bank["birth"],
        bank["usage"], nk, nv, 7.0)
    for k in ("valid", "birth", "usage"):
        torch.testing.assert_close(bank[k], single[k], rtol=0, atol=0)
    for k in ("keys", "values"):
        torch.testing.assert_close(bank[k], single[k], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(evicted.cpu().numpy(),
                                  stats.evicted_n.cpu().numpy())
    assert (evicted > 0).all()
