"""On the card: the largest-CC kernel against its plain version, and the
video step replayed as a CUDA graph against the eager step. Marked
``cuda``; each test skips where there is no GPU. Run on a GPU machine with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda_graph.py``.

- The CC kernel equals the plain version exactly (labels are the smallest
  raster index of each component on both sides, ties to the smaller) on
  random maps of several densities and sizes, batches, an empty map and a
  one-pixel map.
- A small random-init engine: graph replays and the eager step give the
  same bank, tensor for tensor, and labels that agree on > 0.999, and the
  eager step makes no host sync (``set_sync_debug_mode("error")``).
"""

import numpy as np
import pytest
import torch

from vfloodnet_tpu_torch.memory import FeatureBank
from vfloodnet_tpu_torch.models import AFBURR
from vfloodnet_tpu_torch.ops import cc, cc_cuda
from vfloodnet_tpu_torch.pipelines.video_seg import VideoSegEngine

pytestmark = pytest.mark.cuda
BANK = ("keys", "values", "valid", "birth", "usage", "occ", "peak_n",
        "replace_n")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("shape,density", [
    ((1, 30, 53), 0.5), ((3, 97, 61), 0.45), ((2, 416, 416), 0.55),
    ((1, 1, 1), 1.0), ((1, 64, 64), 0.0)])
def test_cc_kernel_equals_plain(dev, shape, density):
    g = torch.Generator(device=dev).manual_seed(sum(shape))
    maps = (torch.rand(shape, device=dev, generator=g) < density).to(
        torch.uint8)
    got = cc_cuda.largest_cc(maps)
    assert torch.equal(got, cc.largest_cc_plain(maps))
    assert torch.equal(cc.largest_connected_component(maps[0]), got[0])


def _clip(n=6, hw=(64, 96)):
    rng = np.random.RandomState(7)
    frames = [(rng.rand(*hw, 3) * 255).astype(np.uint8) for _ in range(n)]
    mask0 = np.zeros(hw, np.uint8)
    mask0[hw[0] // 2:] = 1
    return frames, mask0


def test_graph_replay_equals_eager_step(dev):
    torch.manual_seed(0)
    model = AFBURR().eval().to(dev)
    frames, mask0 = _clip()
    out = {}
    for graph in (False, True):
        eng = VideoSegEngine(model, FeatureBank(obj_n=2, memory_budget=2048,
                                                device=dev),
                             downsample=64, postprocess="device",
                             cuda_graph=graph)
        state = eng.bootstrap(frames[0], mask0)
        labels = []
        for i, f in enumerate(frames[1:]):
            if not graph and i > 0:
                torch.cuda.set_sync_debug_mode("error")
            try:
                state, lab = eng.step(state, f, i + 1)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            labels.append(eng.fetch_label(lab))
        out[graph] = (state, np.stack(labels), eng)
    (s0, l0, _), (s1, l1, eng) = out[False], out[True]
    assert sum(c.replays for c in eng.graphs.values()) > 0
    for name in BANK:
        assert torch.equal(getattr(s0, name), getattr(s1, name)), name
    assert (l0 == l1).mean() > 0.999
