"""The port's Generalized R-CNN against the JAX package's on the CPU, at a
tiny config (blocks (1, 1, 1, 1), ResNeXt groups 4 x width 4, 3 classes,
masks and PointRend, 50 proposals, 8 detections, 128 x 192 input), with
the same weights: Flax's initialisation carried across by
``convert_rcnn_variables``, except two changes made to both models alike
so that a random detector's numbers stay in a trained one's range (raw
Flax init feeds the unscaled pixels through, and its RPN deltas reach
|300|, which float32 cannot decode to 1e-3): the stem's kernel divided by
64, and the prediction layers drawn with Detectron2's initial standard
deviations (0.01 scores, 0.001 deltas and masks).

Each stage is held on the JAX package's input to that stage, so a
difference does not carry into the next. Tolerances: C2-C5 and P2-P6,
coarse and refined mask logits within rtol 1e-4 / atol 1e-4 of each
tensor's scale (convolution sums in another order); proposals and
detections: validity, classes and order equal, boxes within atol 1e-3,
scores within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfloodnet_tpu.models.detection import GeneralizedRCNN as JRCNN
from vfloodnet_tpu.models.detection import RCNNConfig as JConfig
from vfloodnet_tpu.models.detection.heads import PointHead, pointrend_refine
from vfloodnet_tpu.models.detection.meta import build_detector as jbuild
from vfloodnet_tpu_torch.core.checkpoint import flatten
from vfloodnet_tpu_torch.core.convert import convert_rcnn_variables
from vfloodnet_tpu_torch.models.detection import GeneralizedRCNN, RCNNConfig
from vfloodnet_tpu_torch.models.detection.meta import STRIDES, build_detector
from vfloodnet_tpu_torch.ops.roi_align import LevelTable

TINY = dict(num_classes=3, groups=4, width_per_group=4, blocks=(1, 1, 1, 1),
            with_masks=True, with_pointrend=True, post_nms_topk=50,
            max_detections=8, test_short_side=128, test_max_side=192,
            score_thresh=0.0)
HW = (128, 192)
PREDICTOR_STD = {"rpn/head/objectness": 0.01, "rpn/head/deltas": 0.01,
                 "box_head/cls": 0.01, "box_head/bbox": 0.001,
                 "mask_head/predictor": 0.001,
                 "mask_head/prediction": 0.001,
                 "point_head/predictor": 0.001}


def _unflatten(flat):
    out = {}
    for key, v in flat.items():
        node = out
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def _models(seed, **over):
    cfg = dict(TINY, **over)
    jm = JRCNN(JConfig(**cfg))
    v = jax.jit(lambda k, x: jm.init(k, x, method=jm.init_all))(
        jax.random.PRNGKey(seed), jnp.zeros((64, 64, 3)))
    flat = {k: np.array(a, np.float32) for k, a in flatten(v).items()}
    rng = np.random.RandomState(seed)
    flat["params/backbone/stem_conv/kernel"] /= 64.0
    for path, std in PREDICTOR_STD.items():
        key = f"params/{path}/kernel"
        if key in flat:
            flat[key] = (rng.randn(*flat[key].shape) * std).astype(
                np.float32)
    v = _unflatten(flat)
    tm = GeneralizedRCNN(RCNNConfig(**cfg))
    tm.load_state_dict(convert_rcnn_variables(v))
    return jm, v, tm.eval()


def _jax_stages(jm, v, img):
    """The JAX model's three halves on ``img``, each one jit (eager Flax
    would compile op by op)."""
    front = jax.jit(lambda v, x: jm.apply(v, x, method=jm.infer_front))(
        v, jnp.asarray(img))
    det = jax.jit(lambda v, f, p, pv: jm.apply(
        v, f, p, pv, HW, method=jm.infer_boxes))(v, *front)
    tail = jax.jit(lambda v, f, *d: jm.apply(
        v, f, *d, method=jm.infer_tail))(v, front[0], *det)
    return front, det, tail


@pytest.fixture(scope="module")
def pointrend():
    jm, v, tm = _models(0)
    img = (np.random.RandomState(1).rand(*HW, 3) * 255).astype(np.float32)
    return (jm, v, tm, img) + _jax_stages(jm, v, img)


def _close_to_scale(got, want, rtol=1e-4, atol=1e-4):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1.0)
    assert np.abs(np.asarray(got) - want).max() <= rtol * scale + atol, \
        (np.abs(np.asarray(got) - want).max(), scale)


def _port_levels(jf):
    return LevelTable([torch.from_numpy(np.array(f)) for f in jf], STRIDES)


def test_backbone_and_pyramid_match_jax(pointrend):
    jm, v, tm, img, *_ = pointrend
    x = jnp.asarray(img)
    c_j, p_j = jax.jit(lambda v, x: jm.apply(v, x, method=lambda m, x: (
        m.backbone((x - jnp.asarray((103.530, 116.280, 123.675)))[None]),
        m.features(x))))(v, x)
    with torch.no_grad():
        xt = (torch.from_numpy(img) - tm.pixel_mean)[None].permute(0, 3, 1, 2)
        c_t = tm.backbone(xt)
        p_t = tm.fpn(c_t)
    assert len(p_t) == 5
    for j, t in zip(list(c_j) + list(p_j), list(c_t) + list(p_t)):
        _close_to_scale(t[0].permute(1, 2, 0).numpy(), np.asarray(j)[0])


def test_proposals_match_jax(pointrend):
    _, _, tm, img, (jf, jprop, jpv), *_ = pointrend
    with torch.no_grad():
        feats, prop, pv = tm.infer_front(torch.from_numpy(img))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jpv))
    assert int(pv.sum()) > 10
    np.testing.assert_allclose(prop.numpy(), np.asarray(jprop), atol=1e-3,
                               rtol=0)
    for f, j in zip(feats.maps, jf):
        _close_to_scale(f.numpy(), j)


def test_detections_match_jax(pointrend):
    _, _, tm, _, (jf, jprop, jpv), jdet, _ = pointrend
    with torch.no_grad():
        det = tm.infer_boxes(_port_levels(jf), torch.from_numpy(
            np.array(jprop)), torch.from_numpy(np.array(jpv)), HW)
    boxes, scores, classes, valid = (t.numpy() for t in det)
    np.testing.assert_array_equal(valid, np.asarray(jdet[3]))
    assert valid.all()                 # score_thresh 0: every slot a box
    np.testing.assert_array_equal(classes, np.asarray(jdet[2]))
    np.testing.assert_allclose(boxes, np.asarray(jdet[0]), atol=1e-3,
                               rtol=0)
    np.testing.assert_allclose(scores, np.asarray(jdet[1]), atol=1e-5,
                               rtol=0)


def test_pointrend_masks_match_jax(pointrend):
    """The coarse head and PointRend's three subdivisions, every
    detection along one axis, on the JAX package's detections."""
    jm, v, tm, _, (jf, *_), jdet, jtail = pointrend
    det = tuple(torch.from_numpy(np.array(t)) for t in jdet)
    with torch.no_grad():
        tail = tm.infer_tail(_port_levels(jf), *det)
        _close_to_scale(tail["mask_logits"].numpy(), jtail["mask_logits"])
        _close_to_scale(tail["coarse_all"].numpy(), jtail["coarse_all"])
        jin = {k: torch.from_numpy(np.array(a)) for k, a in jtail.items()}
        refined = tm.refine(jin)["mask_logits"].numpy()
    ph = PointHead(3)
    ph_vars = {"params": v["params"]["point_head"]}
    want = jax.jit(jax.vmap(lambda cs, ca, b, c: pointrend_refine(
        ph, ph_vars, cs, ca, c, jtail["p2"], b, num_subdivisions=3)))(
        jtail["mask_logits"], jtail["coarse_all"], jdet[0], jdet[2])
    assert refined.shape == (8, 56, 56)
    _close_to_scale(refined, want)


def test_mask_head_deconv_matches_jax(pointrend):
    """The plain mask head, whose 2x2 stride-2 transposed convolution maps
    to ``ConvTranspose2d`` with a flipped kernel: the head alone on random
    ROI features, then the tail on the PointRend model's maps and
    detections."""
    _, _, _, _, (jf, _, _), jdet, _ = pointrend
    jm, v, tm = _models(2, with_pointrend=False)
    kernel = np.asarray(v["params"]["mask_head"]["deconv"]["kernel"])
    assert not np.allclose(kernel, kernel[::-1, ::-1])   # asymmetric
    pooled = np.random.RandomState(3).randn(5, 14, 14, 256).astype(
        np.float32)
    want = jax.jit(lambda v, x: jm.apply(
        v, x, method=lambda m, x: m.mask_head(x)))(v, jnp.asarray(pooled))
    with torch.no_grad():
        got = tm.mask_head(torch.from_numpy(pooled))
    assert got.shape == (5, 28, 28, 3)
    _close_to_scale(got.numpy(), want)
    jtail = jax.jit(lambda v, f, *d: jm.apply(
        v, f, *d, method=jm.infer_tail))(v, jf, *jdet)
    with torch.no_grad():
        tail = tm.infer_tail(_port_levels(jf), *(
            torch.from_numpy(np.array(t)) for t in jdet))
    _close_to_scale(tail["mask_logits"].numpy(), jtail["mask_logits"])


def test_detector_instances_match_jax(pointrend):
    """The whole detector: Detectron2's resize and padding, the model,
    PointRend, the mask pasting, on a 100 x 150 uint8 image."""
    jm, v, tm, *_ = pointrend
    img = (np.random.RandomState(5).rand(100, 150, 3) * 255).astype(np.uint8)
    want = jbuild(JConfig(**TINY), v)(img)
    got = build_detector(tm)(img)
    assert len(got) == len(want) and len(got) > 0
    np.testing.assert_array_equal(got.classes, want.classes)
    np.testing.assert_allclose(got.boxes, want.boxes, atol=1e-3, rtol=0)
    np.testing.assert_allclose(got.scores, want.scores, atol=1e-5, rtol=0)
    assert (got.masks == want.masks).mean() >= 0.999
