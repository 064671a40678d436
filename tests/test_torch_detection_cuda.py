"""The greedy-NMS kernel (``csrc/nms.cu``) and the detector on the card.
Marked ``cuda``; each test skips where there is no GPU. Run on a GPU
machine with ``python -m pytest --noconftest -m cuda
tests/test_torch_detection_cuda.py``.

- The kernel's keep_idx, keep_scores and valid equal the plain loop's
  exactly, on ties, duplicates, -inf, all-dead inputs and N < max_out:
  both compute the IoU in the same float32 operations and walk the boxes
  in the same order.
- A tiny detector (seeded weights, PointRend) on the card against itself
  on the CPU with the same weights: the pyramid within 1e-4 of each map's
  scale; with the same front half as input, the box half's classes and
  validity equal, boxes within 1e-3 of the image size; with the same
  detections, coarse mask logits within 1e-4 of their scale.
"""

import dataclasses

import numpy as np
import pytest
import torch

from vfloodnet_tpu_torch.models.detection import (GeneralizedRCNN,
                                                  stopsign_rcnn_config)
from vfloodnet_tpu_torch.models.detection.meta import STRIDES, seeded_init
from vfloodnet_tpu_torch.ops import nms as nms_ops
from vfloodnet_tpu_torch.ops import nms_cuda
from vfloodnet_tpu_torch.ops.roi_align import LevelTable

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _case(seed, n, ties, dead, dups):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 300, (n, 2))
    b = np.concatenate([xy, xy + rng.exponential(60, (n, 2)) + 1], 1)
    s = rng.randn(n)
    if ties:
        s = np.round(s, 1)
    s[rng.rand(n) < dead] = -np.inf
    if dups and n > 4:
        k = n // 4
        b[-k:], s[-k:] = b[:k], s[:k]
    return b.astype(np.float32), s.astype(np.float32)


@pytest.mark.parametrize("n,max_out,iou,thr,ties,dead,dups", [
    (4756, 1000, 0.7, 0.0, True, 0.05, True),
    (2048, 100, 0.5, 0.5, True, 0.0, False),
    (500, 100, 0.7, 0.0, False, 1.0, False),
    (37, 100, 0.5, -10.0, True, 0.1, True),
    (1, 5, 0.5, 0.0, False, 0.0, False),
])
def test_nms_kernel_equals_plain(dev, n, max_out, iou, thr, ties, dead,
                                 dups):
    b, s = _case(n, n, ties, dead, dups)
    args = (torch.from_numpy(b).to(dev), torch.from_numpy(s).to(dev), iou,
            max_out, thr)
    before = nms_cuda.launches["nms"]
    got = nms_cuda.nms(*args)
    assert nms_cuda.launches["nms"] == before + 1
    want = nms_ops.nms_plain(*args)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert torch.equal(g, w)


def test_tiny_detector_card_vs_cpu(dev):
    cfg = dataclasses.replace(
        stopsign_rcnn_config(), blocks=(1, 1, 1, 1), groups=4,
        width_per_group=4, num_classes=3, post_nms_topk=50,
        max_detections=8, score_thresh=0.0)
    cpu = seeded_init(GeneralizedRCNN(cfg), 0).eval()
    card = GeneralizedRCNN(cfg)
    card.load_state_dict(cpu.state_dict())
    card = card.to(dev).eval()
    img = torch.from_numpy((np.random.RandomState(1).rand(128, 192, 3)
                            * 255).astype(np.float32))
    hw = (128, 192)
    with torch.no_grad():
        pc, pg = cpu.pyramid(img), card.pyramid(img.to(dev))
        for a, b in zip(pg, pc):
            assert (a.cpu() - b).abs().max() <= 1e-4 * b.abs().max()
        feats_c, prop, pv = cpu.infer_front(img)
        feats_g = LevelTable([f.to(dev) for f in feats_c.maps], STRIDES)
        det_c = cpu.infer_boxes(feats_c, prop, pv, hw)
        det_g = card.infer_boxes(feats_g, prop.to(dev), pv.to(dev), hw)
        assert torch.equal(det_g[2].cpu(), det_c[2])
        assert torch.equal(det_g[3].cpu(), det_c[3])
        assert (det_g[0].cpu() - det_c[0]).abs().max() <= 1e-3 * max(hw)
        tail_c = cpu.infer_tail(feats_c, *det_c)
        tail_g = card.infer_tail(feats_g, *(t.to(dev) for t in det_c))
        a, b = tail_g["mask_logits"].cpu(), tail_c["mask_logits"]
        assert (a - b).abs().max() <= 1e-4 * b.abs().max()
        refined = card.refine(tail_g)["mask_logits"]
        assert refined.shape == (8, 56, 56)
        assert torch.isfinite(refined).all()
