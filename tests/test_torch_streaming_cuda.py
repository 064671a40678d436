"""On the card: the streaming water level replayed as CUDA graphs against
the eager engine, and the water-level ops on the card against the CPU.
Marked ``cuda``; each test skips where there is no GPU. Run on a GPU
machine with ``python -m pytest --noconftest -m cuda
tests/test_torch_streaming_cuda.py``.

- A small random-init engine: ``StreamingWaterLevel`` on graph replays
  and on the eager engine gives equal hits (levels) and equal banks, and
  every step after the first capture makes no host sync
  (``set_sync_debug_mode("error")``).
- The batched waterline scan, the bilinear and nearest perspective warps
  and the MOSSE tracker on the card equal (warps: within 1 grey level;
  tracker: boxes within 1 px, equal ``ok`` flags) their runs on the CPU.
"""

import numpy as np
import pytest
import torch

from vfloodnet_tpu_torch.memory import FeatureBank
from vfloodnet_tpu_torch.models import AFBURR
from vfloodnet_tpu_torch.ops.homography import (find_homography,
                                                warp_perspective,
                                                warp_perspective_mask)
from vfloodnet_tpu_torch.ops.tracker import MosseTracker
from vfloodnet_tpu_torch.ops.waterline import waterline_below_batch
from vfloodnet_tpu_torch.pipelines.streaming_waterlevel import (
    BoundedResolver, StreamingWaterLevel)
from vfloodnet_tpu_torch.pipelines.video_seg import VideoSegEngine

pytestmark = pytest.mark.cuda
BANK = ("keys", "values", "valid", "birth", "usage", "occ", "peak_n",
        "replace_n")
BOXES = [(4, 2, 8, 10), (40, 12, 10, 8), (80, 0, 12, 20)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _clip(n=7, hw=(64, 96)):
    rng = np.random.RandomState(11)
    frames = [(rng.rand(*hw, 3) * 255).astype(np.uint8) for _ in range(n)]
    mask0 = np.zeros(hw, np.uint8)
    mask0[hw[0] // 2:] = 1
    return frames, mask0


def test_streaming_replay_equals_eager(dev):
    torch.manual_seed(0)
    model = AFBURR().eval().to(dev)
    frames, mask0 = _clip()
    out = {}
    for graph in (False, True):
        eng = VideoSegEngine(model, FeatureBank(obj_n=2, memory_budget=2048,
                                                device=dev),
                             downsample=64, postprocess="none",
                             cuda_graph=graph)
        stream = StreamingWaterLevel(eng, BOXES)
        resolver = BoundedResolver(stream, len(BOXES), lag=2)
        state = eng.bootstrap(frames[0], mask0)
        raw, smalls = [], []
        for i, f in enumerate(frames[1:]):
            if i > 1:                # after the warm-up and the capture
                torch.cuda.set_sync_debug_mode("error")
            try:
                state, pending, small = stream.step_async(state, f, i + 1)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            resolver.push(pending)
            assert len(resolver.pending) <= 2
            raw.append(pending)
            smalls.append(small.cpu().numpy())
        levels = resolver.finish()
        out[graph] = (state, [stream.resolve(p) for p in raw], levels,
                      np.stack(smalls), eng)
    (s0, r0, l0, m0, _), (s1, r1, l1, m1, eng) = out[False], out[True]
    assert sum(c.replays for c in eng.graphs.values()) >= 4
    for name in BANK:
        assert torch.equal(getattr(s0, name), getattr(s1, name)), name
    np.testing.assert_array_equal(m0, m1)
    np.testing.assert_array_equal(np.array(r0), np.array(r1))
    assert l0 == l1


def test_waterlevel_ops_on_card_match_cpu(dev):
    rng = np.random.default_rng(5)
    mask = (rng.random((120, 200)) > 0.6).astype(np.uint8)
    cols = torch.from_numpy(rng.integers(-10, 210, 64).astype(np.int32))
    rows = torch.from_numpy(rng.integers(-2, 122, 64).astype(np.int32))
    want = waterline_below_batch(torch.from_numpy(mask), cols, rows)
    got = waterline_below_batch(torch.from_numpy(mask).to(dev), cols.to(dev),
                                rows.to(dev))
    assert torch.equal(got.cpu(), want)
    img = rng.integers(0, 256, (270, 480, 3), dtype=np.uint8)
    src = np.array([[0, 0], [479, 0], [0, 269], [479, 269]], np.float64)
    hm = find_homography(src, src + rng.uniform(-15, 15, src.shape))
    host = torch.from_numpy(img)
    diff = (warp_perspective(host.to(dev), hm).cpu().int()
            - warp_perspective(host, hm).int()).abs()
    assert int(diff.max()) <= 1
    m = torch.from_numpy(mask)
    assert torch.equal(warp_perspective_mask(m.to(dev), hm).cpu(),
                       warp_perspective_mask(m, hm))
    frames = []
    for t in range(12):
        g = rng.uniform(0, 60, (200, 200)).astype(np.float32)
        g[60 + 2 * t:90 + 2 * t, 50 + 3 * t:80 + 3 * t] = \
            (np.indices((30, 30)).sum(0) % 7) * 25.0 + 120.0
        frames.append(g)
    trackers = {d: MosseTracker(device=d) for d in ("cuda", "cpu")}
    for tr in trackers.values():
        tr.init(frames[0], (50, 60, 30, 30))
    for f in frames[1:]:
        (ok_c, box_c), (ok_h, box_h) = (trackers[d].update(f)
                                        for d in ("cuda", "cpu"))
        assert ok_c == ok_h
        assert max(abs(a - b) for a, b in zip(box_c, box_h)) <= 1
