"""The people path on the card. Marked ``cuda``; each test skips where there
is no GPU. Run on a GPU machine with ``python -m pytest --noconftest -m cuda
tests/test_torch_people_cuda.py``.

- The NMS kernel at the one-class box head's shape (1,000 candidates,
  IoU 0.5, 100 kept, score > 0.7, ties and duplicates) equals the plain
  loop exactly.
- A tiny Keypoint R-CNN (seeded, one class, keypoints and masks, as the
  bundled ``people_tiny`` has them) on the card against itself on the
  CPU, on the same detections: heatmaps within 1e-4 of their scale.
- The body-mesh regressors at narrow widths (seeded), a batch of 3 crops
  on the card against the CPU: projected vertices within 1e-4.
- The per-image chain (``people_depth``) on both people fixtures with the
  trained tiny detector's boxes: card and CPU rows equal.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from vfloodnet_tpu_torch.models.detection import (GeneralizedRCNN,
                                                  keypoint_rcnn_config)
from vfloodnet_tpu_torch.models.detection.meta import STRIDES, seeded_init
from vfloodnet_tpu_torch.models.metro import (BodyMeshRegressor,
                                              METRONetwork, MeshRegressor)
from vfloodnet_tpu_torch.models.metro import seeded_init as mesh_init
from vfloodnet_tpu_torch.ops import nms as nms_ops
from vfloodnet_tpu_torch.ops import nms_cuda
from vfloodnet_tpu_torch.ops.roi_align import LevelTable
from vfloodnet_tpu_torch.pipelines.object_detection import (Instances,
                                                            load_template_3d,
                                                            people_depth)

pytestmark = pytest.mark.cuda
FIXTURE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "records", "port_fixtures", "people_scene{}_{}.npy")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def test_nms_kernel_one_class_box_head_shape(dev):
    rng = np.random.RandomState(12)
    xy = rng.uniform(0, 1300, (1000, 2))
    b = np.concatenate([xy, xy + rng.exponential(120, (1000, 2)) + 1], 1)
    s = np.where(rng.rand(1000) < 0.4, 0.0, np.round(rng.rand(1000), 2))
    b[900:], s[900:] = b[:100], s[:100]
    args = (torch.tensor(b, dtype=torch.float32, device=dev),
            torch.tensor(s, dtype=torch.float32, device=dev), 0.5, 100, 0.7)
    got, want = nms_cuda.nms(*args), nms_ops.nms_plain(*args)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert 0 < int(want[2].sum()) <= 100


def test_tiny_keypoint_detector_card_vs_cpu(dev):
    cfg = dataclasses.replace(
        keypoint_rcnn_config(), blocks=(1, 1, 1, 1), width_per_group=8,
        with_masks=True, post_nms_topk=50, max_detections=8,
        score_thresh=0.0)
    cpu = seeded_init(GeneralizedRCNN(cfg), 0).eval()
    card = GeneralizedRCNN(cfg)
    card.load_state_dict(cpu.state_dict())
    card = card.to(dev).eval()
    img = torch.from_numpy((np.random.RandomState(1).rand(128, 192, 3)
                            * 255).astype(np.float32))
    with torch.no_grad():
        feats_c, prop, pv = cpu.infer_front(img)
        det = cpu.infer_boxes(feats_c, prop, pv, (128, 192))
        feats_g = LevelTable([f.to(dev) for f in feats_c.maps], STRIDES)
        tail_c = cpu.infer_tail(feats_c, *det)
        tail_g = card.infer_tail(feats_g, *(t.to(dev) for t in det))
    a, b = tail_g["keypoint_heatmaps"].cpu(), tail_c["keypoint_heatmaps"]
    assert a.shape == (8, 56, 56, 17) and "mask_logits" in tail_g
    assert (a - b).abs().max() <= 1e-4 * b.abs().max()


@pytest.mark.parametrize("cls,kwargs", [
    (BodyMeshRegressor, {"stage_dims": (64, 32, 16)}),
    (METRONetwork, {"backbone": "resnet50", "stage_hidden": (64, 32, 16),
                    "stage_out": (32, 16, 3), "stage_layers": 2,
                    "intermediate": 96})], ids=["bodymesh", "metro"])
def test_mesh_regressor_card_vs_cpu(dev, cls, kwargs):
    model = mesh_init(cls(**kwargs), 0)
    card_model = cls(**kwargs)
    card_model.load_state_dict(model.state_dict())
    crops = (np.random.RandomState(2).rand(3, 224, 224, 3) * 255).astype(
        np.uint8)
    got = MeshRegressor(card_model.to(dev))(crops)
    want = MeshRegressor(model)(crops)
    assert got.shape == (3, 431, 2)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_people_depth_card_vs_cpu(dev):
    model = mesh_init(BodyMeshRegressor(stage_dims=(64, 32, 16)), 0)
    cpu = MeshRegressor(model)
    card_model = BodyMeshRegressor(stage_dims=(64, 32, 16))
    card_model.load_state_dict(model.state_dict())
    card = MeshRegressor(card_model.to(dev))
    template = load_template_3d()
    for i in (0, 1):
        frame = np.load(FIXTURE.format(i, "frame"))
        water = np.load(FIXTURE.format(i, "mask"))
        d = np.load(FIXTURE.format(i, "det"))
        inst = Instances(boxes=d[:, :4], scores=d[:, 4],
                         classes=np.zeros(len(d), np.int32))
        rows = [people_depth(frame, inst, water, reg, template)[:2]
                for reg in (card, cpu)]
        assert rows[0] == rows[1]
