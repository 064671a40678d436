"""The stream axis on the card: the bank read, combine and count kernels
(float32 and bf16) with q [B, P, dk] against the banks of B streams folded
along the object axis, and the multi-stream engine's graph replay. Marked
``cuda``; each test skips where there is no GPU. Run on a GPU machine with
``python -m pytest --noconftest -m cuda tests/test_torch_batch_cuda.py``.

- Each stream's rows of one stream-axis launch equal that stream's own
  launch on its plane and bank rows, at the same segments: the kernels
  compute every (object, tile) alone, and the bf16 count's shares add
  whole numbers.
- Against the plain versions per object: the tolerances of
  tests/test_torch_kernels_cuda.py (mem rtol 2e-4 / atol 2e-5, bf16 rtol
  1e-2 / atol 2e-3; counts within 1).
- ``BatchVideoSegEngine`` replaying its step as a CUDA graph keeps the
  bank of its eager steps tensor for tensor.
"""

import numpy as np
import pytest
import torch

from vfloodnet_tpu_torch.memory import FeatureBank
from vfloodnet_tpu_torch.models import AFBURR
from vfloodnet_tpu_torch.ops import attention, bank_read_cuda
from vfloodnet_tpu_torch.pipelines import BatchVideoSegEngine

pytestmark = pytest.mark.cuda
B, OBJ = 3, 2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n,p,occ", [(20000, 100, 9000), (1000, 37, None)])
def test_stream_axis_kernels(dev, dtype, n, p, occ):
    g = torch.Generator(device=dev).manual_seed(0)
    rows = B * OBJ
    keys = torch.randn(rows, n, 128, device=dev, generator=g).to(dtype)
    values = torch.randn(rows, n, 512, device=dev, generator=g).to(dtype)
    valid = torch.rand(rows, n, device=dev, generator=g) < 0.8
    q = (3.0 * torch.randn(B, p, 128, device=dev, generator=g)).to(dtype)
    occ_t = None if occ is None else torch.tensor([occ], dtype=torch.int32,
                                                  device=dev)
    chunk = attention.OCC_CHUNK
    parts = bank_read_cuda.bank_read_partials(q, keys, values, valid, occ_t,
                                              chunk, 3)
    mem, m, l, log_thres = bank_read_cuda.bank_read_combine(*parts, 1e-3)
    cnt = bank_read_cuda.bank_count(q, keys, valid, occ_t, log_thres, chunk)
    bound = n if occ is None else occ
    tol = (dict(rtol=2e-4, atol=2e-5) if dtype == torch.float32
           else dict(rtol=1e-2, atol=2e-3))
    for o in range(rows):
        qo = attention.query_plane(q, o, rows)
        want, wm, wl = attention._read_occ_sweep(keys[o], values[o],
                                                 valid[o], qo, chunk, bound)
        want_cnt = attention._count_occ_sweep(keys[o], valid[o], qo,
                                              log_thres[o], chunk, bound)
        torch.testing.assert_close(mem[o], want, **tol)
        assert (cnt[o] - want_cnt).abs().max().item() <= 1.0
    for b in range(B):
        r = slice(OBJ * b, OBJ * (b + 1))
        one = bank_read_cuda.bank_read_partials(q[b], keys[r], values[r],
                                                valid[r], occ_t, chunk, 3)
        mem_b, _, _, lt_b = bank_read_cuda.bank_read_combine(*one, 1e-3)
        cnt_b = bank_read_cuda.bank_count(q[b], keys[r], valid[r], occ_t,
                                          lt_b, chunk)
        assert torch.equal(mem_b, mem[r]) and torch.equal(cnt_b, cnt[r])
    assert cnt.sum() > 0
    with pytest.raises(ValueError, match="dividing"):
        bank_read_cuda.bank_count(q[:2], keys[:5], valid[:5], occ_t,
                                  log_thres[:5], chunk)


def test_batch_engine_graph_keeps_the_eager_bank(dev):
    torch.manual_seed(0)
    model = AFBURR().to(dev).eval()
    rng = np.random.RandomState(0)
    frames = [(rng.rand(2, 120, 160, 3) * 255).astype(np.uint8)
              for _ in range(5)]
    mask = np.zeros((120, 160), np.uint8)
    mask[60:] = 1
    states, labels = {}, {}
    for graph in (False, True):
        eng = BatchVideoSegEngine(model, FeatureBank(
            obj_n=2, memory_budget=4096, device=dev), batch=2,
            downsample=120, postprocess="device", cuda_graph=graph)
        st = eng.bootstrap(list(frames[0]), [mask, mask])
        labs = []
        for i, f in enumerate(frames[1:]):
            st, lab = eng.step(st, f, i + 1)
            labs.append(eng.fetch_labels(lab))
        states[graph], labels[graph] = st, np.stack(labs)
        if graph:
            assert sum(c.replays for c in eng.graphs.values()) > 0
    for k in ("keys", "values", "valid", "birth", "usage", "occ",
              "peak_n", "replace_n"):
        assert torch.equal(getattr(states[False], k),
                           getattr(states[True], k)), k
    assert (labels[False] == labels[True]).mean() > 0.999
