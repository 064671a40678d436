"""The people detector's pieces in the port against the JAX package on the
CPU, with the same weights:

- ``KeypointHead`` at a narrow width (32 -> 64 channels, 8 convolutions)
  on random ROI features: heatmaps within 1e-5 of their scale. Its 4x4
  stride-2 transposed convolution (Flax "SAME" padding) is
  ``ConvTranspose2d(p=1)`` with a flipped kernel, and its 2x upsample is
  ``jax.image.resize``'s ``linear``: the unflipped kernel and
  ``F.interpolate``'s bilinear (both checked here) are off by more.
- ``heatmaps_to_keypoints`` equals the JAX package's ``_heatmaps_to_keypoints``
  exactly, ties (a constant map, repeated maxima) to the first index.
- A tiny Keypoint R-CNN (one class, keypoints, blocks (1, 1, 1, 1), as
  ``tests/test_detection_model.py`` builds one), Flax's initialisation
  carried across by ``convert_rcnn_variables`` with the stem divided by 64
  and Detectron2's predictor deviations (as
  ``tests/test_torch_detection_model.py``): the box half and the keypoint
  head on the JAX package's inputs to them (boxes within 1e-3, heatmaps
  within 1e-4 of scale), then the whole detector on a uint8 image (boxes
  within 1e-3, keypoints within 1e-3 px and 1e-5 in score).
- The Detectron2 keypoint keys (``conv_fcn1..8``, ``score_lowres``)
  through the port's converter equal the JAX converter's followed by
  ``convert_rcnn_variables``, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vfloodnet_tpu.core.convert_d2 import \
    convert_d2_state_dict as jax_convert_d2
from vfloodnet_tpu.models.detection import GeneralizedRCNN as JRCNN
from vfloodnet_tpu.models.detection import RCNNConfig as JConfig
from vfloodnet_tpu.models.detection.heads import \
    KeypointHead as JKeypointHead
from vfloodnet_tpu.models.detection.meta import _heatmaps_to_keypoints
from vfloodnet_tpu.models.detection.meta import build_detector as jbuild
from vfloodnet_tpu_torch.core.checkpoint import flatten
from vfloodnet_tpu_torch.core.convert import convert_rcnn_variables
from vfloodnet_tpu_torch.core.convert_d2 import convert_d2_state_dict
from vfloodnet_tpu_torch.models.detection import (GeneralizedRCNN,
                                                  KeypointHead, RCNNConfig)
from vfloodnet_tpu_torch.models.detection.meta import (STRIDES,
                                                       build_detector,
                                                       heatmaps_to_keypoints)
from vfloodnet_tpu_torch.ops.roi_align import LevelTable

TINY = dict(num_classes=1, blocks=(1, 1, 1, 1), width_per_group=8,
            with_keypoints=True, post_nms_topk=40, max_detections=4,
            test_short_side=128, test_max_side=192, score_thresh=0.0)
HW = (128, 192)
PREDICTOR_STD = {"rpn/head/objectness": 0.01, "rpn/head/deltas": 0.01,
                 "box_head/cls": 0.01, "box_head/bbox": 0.001}


def _close_to_scale(got, want, rtol):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    scale = float(np.abs(want).max())
    assert err <= rtol * scale, (err, scale)
    return err / scale


def _unflatten(flat):
    out = {}
    for key, v in flat.items():
        node = out
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def test_keypoint_head_matches_jax():
    jm = JKeypointHead(17, conv_dim=64)
    pooled = np.random.RandomState(0).randn(5, 14, 14, 32).astype(np.float32)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(pooled))
    want = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(pooled)))
    kernel = np.asarray(v["params"]["deconv"]["kernel"])
    assert kernel.shape == (4, 4, 64, 17)
    assert not np.allclose(kernel, kernel[::-1, ::-1])     # asymmetric
    sd = convert_rcnn_variables({"params": v["params"]})
    x = torch.from_numpy(pooled)

    def run(state, upsample=None):
        m = KeypointHead(17, in_channels=32, conv_dim=64).eval()
        m.load_state_dict(state)
        with torch.no_grad():
            if upsample is None:
                return m(x).numpy()
            h = x.permute(0, 3, 1, 2)
            for i in range(8):
                h = F.relu(getattr(m, f"conv{i}")(h))
            return upsample(m.deconv(h)).permute(0, 2, 3, 1).numpy()

    got = run(sd)
    assert got.shape == want.shape == (5, 56, 56, 17)
    _close_to_scale(got, want, 1e-5)
    scale = np.abs(want).max()
    unflipped = np.abs(run({**sd, "deconv.weight": sd["deconv.weight"].flip(
        -1, -2)}) - want).max() / scale
    interp = np.abs(run(sd, lambda h: F.interpolate(
        h, scale_factor=2, mode="bilinear", align_corners=True))
        - want).max() / scale
    assert unflipped > 1e-2 and interp > 1e-3, (unflipped, interp)


def test_heatmaps_to_keypoints_match_jax_with_ties():
    rng = np.random.RandomState(1)
    heat = rng.randn(6, 56, 56, 17).astype(np.float32)
    heat[0] = 0.5                                # a constant map
    heat[1, 10, 20, :] = heat[1, 30, 5, :] = 9.0  # two equal maxima
    heat[2] = np.round(heat[2])                  # many ties
    boxes = np.abs(rng.randn(6, 4).astype(np.float32)) * 50
    boxes[:, 2:] += boxes[:, :2] + 1
    boxes[3, 2] = boxes[3, 0]                    # a zero-width box
    want = _heatmaps_to_keypoints(heat, boxes)
    got = heatmaps_to_keypoints(heat, boxes)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    corner = boxes[0, :2] + np.float64(0.5 / 56) * (boxes[0, 2:]
                                                   - boxes[0, :2])
    np.testing.assert_array_equal(got[0, :, :2],
                                  np.broadcast_to(corner, (17, 2)))


@pytest.fixture(scope="module")
def keypoint_rcnn():
    jm = JRCNN(JConfig(**TINY))
    v = jax.jit(lambda k, x: jm.init(k, x, method=jm.init_all))(
        jax.random.PRNGKey(0), jnp.zeros((64, 64, 3)))
    flat = {k: np.array(a, np.float32) for k, a in flatten(v).items()}
    rng = np.random.RandomState(0)
    flat["params/backbone/stem_conv/kernel"] /= 64.0
    for path, std in PREDICTOR_STD.items():
        key = f"params/{path}/kernel"
        flat[key] = (rng.randn(*flat[key].shape) * std).astype(np.float32)
    v = _unflatten(flat)
    tm = GeneralizedRCNN(RCNNConfig(**TINY))
    tm.load_state_dict(convert_rcnn_variables(v))
    return jm, v, tm.eval()


def test_keypoint_rcnn_stages_match_jax(keypoint_rcnn):
    """The box half and the keypoint head, each on the JAX package's input
    to it."""
    jm, v, tm = keypoint_rcnn
    img = (np.random.RandomState(2).rand(*HW, 3) * 255).astype(np.float32)
    front = jax.jit(lambda v, x: jm.apply(v, x, method=jm.infer_front))(
        v, jnp.asarray(img))
    jdet = jax.jit(lambda v, f, p, pv: jm.apply(
        v, f, p, pv, HW, method=jm.infer_boxes))(v, *front)
    jtail = jax.jit(lambda v, f, *d: jm.apply(
        v, f, *d, method=jm.infer_tail))(v, front[0], *jdet)
    feats = LevelTable([torch.from_numpy(np.array(f)) for f in front[0]],
                       STRIDES)
    with torch.no_grad():
        det = tm.infer_boxes(feats, torch.from_numpy(np.array(front[1])),
                             torch.from_numpy(np.array(front[2])), HW)
        tail = tm.infer_tail(feats, *(torch.from_numpy(np.array(t))
                                      for t in jdet))
    np.testing.assert_array_equal(det[3].numpy(), np.asarray(jdet[3]))
    assert det[3].numpy().all()
    np.testing.assert_allclose(det[0].numpy(), np.asarray(jdet[0]),
                               atol=1e-3, rtol=0)
    heat = tail["keypoint_heatmaps"].numpy()
    assert heat.shape == (4, 56, 56, 17) and "mask_logits" not in tail
    _close_to_scale(heat, jtail["keypoint_heatmaps"], 1e-4)


def test_keypoint_detector_matches_jax(keypoint_rcnn):
    """The whole detector on a uint8 image: Detectron2's resize and
    padding, the model, the keypoints from their heatmaps."""
    jm, v, tm = keypoint_rcnn
    img = (np.random.RandomState(5).rand(100, 150, 3) * 255).astype(np.uint8)
    want = jbuild(JConfig(**TINY), v)(img)
    got = build_detector(tm)(img)
    assert len(got) == len(want) == 4
    np.testing.assert_allclose(got.boxes, want.boxes, atol=1e-3, rtol=0)
    np.testing.assert_allclose(got.scores, want.scores, atol=1e-5, rtol=0)
    assert got.masks is None and got.keypoints.shape == (4, 17, 3)
    np.testing.assert_allclose(got.keypoints[..., :2],
                               want.keypoints[..., :2], atol=1e-3, rtol=0)
    np.testing.assert_allclose(got.keypoints[..., 2],
                               want.keypoints[..., 2], atol=1e-5, rtol=0)


def test_d2_keypoint_keys_match_jax_route(keypoint_rcnn):
    _, v, _ = keypoint_rcnn
    flat = flatten(v)
    rng = np.random.RandomState(3)
    sd = {}
    for i in range(8):
        k = flat[f"params/keypoint_head/conv{i}/kernel"]
        sd[f"roi_heads.keypoint_head.conv_fcn{i + 1}.weight"] = rng.randn(
            k.shape[3], k.shape[2], k.shape[0], k.shape[1]).astype(np.float32)
        sd[f"roi_heads.keypoint_head.conv_fcn{i + 1}.bias"] = rng.randn(
            k.shape[3]).astype(np.float32)
    dk = flat["params/keypoint_head/deconv/kernel"]        # [4, 4, in, 17]
    sd["roi_heads.keypoint_head.score_lowres.weight"] = rng.randn(
        dk.shape[2], dk.shape[3], 4, 4).astype(np.float32)
    sd["roi_heads.keypoint_head.score_lowres.bias"] = rng.randn(
        dk.shape[3]).astype(np.float32)
    got = convert_d2_state_dict(sd, with_keypoints=True)
    want = convert_rcnn_variables(jax_convert_d2(sd, with_keypoints=True))
    assert set(got) == set(want) and len(got) == 18
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # Detectron2's [in, out, kh, kw] weight is applied flipped, as the JAX
    # package's Flax layer applies it
    np.testing.assert_array_equal(
        got["keypoint_head.deconv.weight"].numpy(),
        sd["roi_heads.keypoint_head.score_lowres.weight"][:, :, ::-1, ::-1])
    assert convert_d2_state_dict(sd) == {}        # keypoints not asked for
