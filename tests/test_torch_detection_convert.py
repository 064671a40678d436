"""The detector's weight bridges against the JAX package's, on the CPU.

- ``convert_d2_state_dict`` (Detectron2 -> the port) equals the JAX
  package's ``convert_d2_state_dict`` followed by ``convert_rcnn_variables``
  array for array (bit-equal: both only transpose and flip), on a
  synthetic Detectron2 dict built from a tiny model's shapes as
  ``tests/test_convert_d2.py`` builds one, the mask head's deconvolution
  and PointRend's point head (Conv1d weights) included; so does the
  pickle route.
- ``convert_rcnn_variables`` uses every Flax array of a tiny PointRend
  model exactly once and fills every port parameter; an extra array
  raises.
- ``load_default_detector`` reads the bundled tiny checkpoints with their
  sidecar configurations (the people one builds the mask and keypoint
  heads side by side), and refuses an orbax directory.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfloodnet_tpu.core.convert_d2 import \
    convert_d2_state_dict as jax_convert_d2
from vfloodnet_tpu.models.detection import GeneralizedRCNN as JRCNN
from vfloodnet_tpu.models.detection import RCNNConfig as JConfig
from vfloodnet_tpu_torch.core.checkpoint import flatten
from vfloodnet_tpu_torch.core.convert import convert_rcnn_variables
from vfloodnet_tpu_torch.core.convert_d2 import (convert_d2_checkpoint,
                                                 convert_d2_state_dict)
from vfloodnet_tpu_torch.models.detection import (GeneralizedRCNN,
                                                  RCNNConfig,
                                                  load_default_detector)

TINY = dict(num_classes=4, groups=4, width_per_group=4, blocks=(1, 1, 1, 1),
            with_masks=True, post_nms_topk=20, max_detections=5)


def _flax(**over):
    cfg = dict(TINY, **over)
    jm = JRCNN(JConfig(**cfg))
    v = jax.jit(lambda k, x: jm.init(k, x, method=jm.init_all))(
        jax.random.PRNGKey(0), jnp.zeros((64, 64, 3)))
    return cfg, {k: np.asarray(a) for k, a in flatten(v).items()}


@pytest.fixture(scope="module")
def mask_model():
    return _flax()


def _d2_dict(flat, point_head=False):
    """A Detectron2 state dict of random arrays with the shapes of the
    Flax tree ``flat``."""
    rng = np.random.RandomState(0)
    sd = {}

    def arr(*shape):
        return rng.randn(*shape).astype(np.float32)

    def conv(tkey, fpath, bias=False):
        k = flat[f"params/{fpath}/kernel"]
        sd[tkey + ".weight"] = arr(k.shape[3], k.shape[2], k.shape[0],
                                   k.shape[1])
        if bias:
            sd[tkey + ".bias"] = arr(k.shape[3])

    def norm(tkey, fpath):
        c = flat[f"params/{fpath}/scale"].shape[0]
        sd[tkey + ".norm.weight"] = arr(c)
        sd[tkey + ".norm.bias"] = arr(c)
        sd[tkey + ".norm.running_mean"] = arr(c)
        sd[tkey + ".norm.running_var"] = rng.rand(c).astype(np.float32) + .5

    def dense(tkey, fpath, conv1d=False):
        k = flat[f"params/{fpath}/kernel"]
        w = arr(k.shape[1], k.shape[0])
        sd[tkey + ".weight"] = w[..., None] if conv1d else w
        sd[tkey + ".bias"] = arr(k.shape[1])

    conv("backbone.bottom_up.stem.conv1", "backbone/stem_conv")
    norm("backbone.bottom_up.stem.conv1", "backbone/stem_bn")
    blocks = sorted({k.split("/")[2] for k in flat
                     if k.startswith("params/backbone/res")})
    for blk in blocks:
        t = f"backbone.bottom_up.res{blk[3]}.{blk.split('block')[1]}"
        for i, (cm, bm) in enumerate((("conv1", "bn1"), ("conv2", "bn2"),
                                      ("conv3", "bn3"))):
            conv(f"{t}.conv{i + 1}", f"backbone/{blk}/{cm}")
            norm(f"{t}.conv{i + 1}", f"backbone/{blk}/{bm}")
        if f"params/backbone/{blk}/shortcut/kernel" in flat:
            conv(f"{t}.shortcut", f"backbone/{blk}/shortcut")
            norm(f"{t}.shortcut", f"backbone/{blk}/shortcut_bn")
    for lvl in range(2, 6):
        for kind in ("lateral", "output"):
            conv(f"backbone.fpn_{kind}{lvl}", f"fpn/{kind}{lvl}", bias=True)
    for tmod, fmod in (("conv", "conv"), ("objectness_logits", "objectness"),
                       ("anchor_deltas", "deltas")):
        conv(f"proposal_generator.rpn_head.{tmod}", f"rpn/head/{fmod}",
             bias=True)
    for i in (1, 2):
        dense(f"roi_heads.box_head.fc{i}", f"box_head/fc{i}")
    dense("roi_heads.box_predictor.cls_score", "box_head/cls")
    dense("roi_heads.box_predictor.bbox_pred", "box_head/bbox")
    if not point_head:
        for i in range(1, 5):
            conv(f"roi_heads.mask_head.mask_fcn{i}", f"mask_head/conv{i - 1}",
                 bias=True)
        dk = flat["params/mask_head/deconv/kernel"]
        sd["roi_heads.mask_head.deconv.weight"] = arr(
            dk.shape[2], dk.shape[3], dk.shape[0], dk.shape[1])
        sd["roi_heads.mask_head.deconv.bias"] = arr(dk.shape[3])
        conv("roi_heads.mask_head.predictor", "mask_head/predictor",
             bias=True)
    else:
        for i in range(1, 4):
            dense(f"roi_heads.mask_head.point_head.fc{i}",
                  f"point_head/fc{i - 1}", conv1d=True)
        dense("roi_heads.mask_head.point_head.predictor",
              "point_head/predictor", conv1d=True)
    return sd


def _equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_d2_mask_model_matches_jax_route(mask_model):
    cfg, flat = mask_model
    sd = _d2_dict(flat)
    got = convert_d2_state_dict(sd, with_masks=True)
    want = convert_rcnn_variables(jax_convert_d2(sd, with_masks=True))
    _equal(got, want)
    model = GeneralizedRCNN(RCNNConfig(**cfg))
    model.load_state_dict(got)          # strict: every parameter filled


def test_d2_point_head_matches_jax_route():
    _, flat = _flax(with_pointrend=True)
    sd = _d2_dict(flat, point_head=True)
    got = convert_d2_state_dict(sd, with_masks=True, with_pointrend=True)
    want = convert_rcnn_variables(jax_convert_d2(
        sd, with_masks=True, with_pointrend=True))
    _equal(got, want)
    assert got["point_head.fc0.weight"].shape == \
        sd["roi_heads.mask_head.point_head.fc1.weight"].shape[:2]


def test_d2_pickle_route(mask_model, tmp_path):
    sd = _d2_dict(mask_model[1])
    path = tmp_path / "model_final.pkl"
    with open(path, "wb") as f:
        pickle.dump({"model": sd, "__author__": "synthetic"}, f)
    _equal(convert_d2_checkpoint(str(path), with_masks=True),
           convert_d2_state_dict(sd, with_masks=True))


def test_convert_rcnn_variables_uses_every_array(mask_model):
    cfg, flat = mask_model
    sd = convert_rcnn_variables(flat)
    model = GeneralizedRCNN(RCNNConfig(**cfg))
    model.load_state_dict(sd)
    assert torch.equal(sd["mask_head.deconv.weight"], torch.from_numpy(
        np.ascontiguousarray(np.transpose(
            flat["params/mask_head/deconv/kernel"], (2, 3, 0, 1))[
                :, :, ::-1, ::-1])))
    with pytest.raises(KeyError):
        convert_rcnn_variables({**flat, "params/extra/kernel_x": np.ones(2)})


def test_load_default_detector(tmp_path):
    det = load_default_detector("stopsign", device="cpu")
    cfg = det.cfg
    assert (cfg.blocks, cfg.num_classes, cfg.max_detections,
            cfg.with_masks, cfg.with_pointrend) == ((1, 1, 1, 1), 80, 16,
                                                    True, False)
    assert det.device == torch.device("cpu")
    with pytest.raises(ValueError, match="orbax"):
        load_default_detector("stopsign", str(tmp_path), device="cpu")
    people = load_default_detector("people", device="cpu").cfg
    assert (people.blocks, people.with_masks, people.with_keypoints) == \
        ((1, 1, 1, 1), True, True)
    with pytest.raises(ValueError, match="unknown"):
        load_default_detector("cars", device="cpu")
