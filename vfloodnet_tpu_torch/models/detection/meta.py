"""Generalized R-CNN: backbone -> FPN -> RPN -> ROI heads (counterpart of
``vfloodnet_tpu.models.detection.meta``), static shapes.

:class:`GeneralizedRCNN` has the JAX module's three halves as plain
methods: :meth:`~GeneralizedRCNN.infer_front` (backbone, FPN, RPN),
:meth:`~GeneralizedRCNN.infer_boxes` (box head, class-aware NMS) and
:meth:`~GeneralizedRCNN.infer_tail` (mask and keypoint heads);
:meth:`refine` is PointRend's subdivision over every detection at once.
Between them nothing is read back to the host, so on the card the forward
makes no host sync. :func:`build_detector` wraps a model into the
pipeline's detector: a BGR uint8 image in, :class:`Instances` out, with
Detectron2's resize on the model's device, the masks pasted (OpenCV's
``INTER_LINEAR`` of ``ops/resize.py``: the card's machine has no cv2) and
the keypoints read from their heatmaps (numpy's ``argmax``, the first
index on ties) on the host.

``GeneralizedRCNN(cfg, trainable_bn=True)`` is the training form
(``train/train_detection.py``): the backbone's BNs are
:class:`..resnet.TrainBN`, frozen, and the trainer calls the JAX module's
trainer-facing pieces, :meth:`~GeneralizedRCNN.features`,
:meth:`~GeneralizedRCNN.rpn_raw`, :meth:`~GeneralizedRCNN.box_apply`,
:meth:`~GeneralizedRCNN.mask_apply` and
:meth:`~GeneralizedRCNN.keypoint_apply`, differentiable through the
ROIAlign gathers.

The JAX package's ``jit_split`` is not ported: it works around a TPU
crash.
"""

from __future__ import annotations

import dataclasses
import json
import os
import warnings
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ...core.device import resolve_device
from ...ops.resize import cv2_linear_f32, cv2_linear_u8
from ...ops.roi_align import LevelTable
from ..resnet import FrozenBN, TrainBN
from .backbone import DetectionResNet
from .fpn import FPN
from .heads import (BoxHead, CoarseMaskHead, KeypointHead, MaskHead,
                    PointHead, box_inference, pointrend_refine)
from .rpn import RPN

# Detectron2 caffe-style preprocessing (BGR, mean-subtract, no std scaling)
PIXEL_MEAN_BGR = (103.530, 116.280, 123.675)
STRIDES = (4, 8, 16, 32)


@dataclasses.dataclass(frozen=True)
class RCNNConfig:
    """The JAX package's ``RCNNConfig`` but for ``jit_split``, a TPU
    workaround (a sidecar's is dropped)."""
    num_classes: int = 80
    groups: int = 1
    width_per_group: int = 64
    blocks: tuple = (3, 4, 23, 3)
    score_thresh: float = 0.5
    nms_thresh: float = 0.5
    max_detections: int = 100
    post_nms_topk: int = 1000
    with_masks: bool = False
    with_pointrend: bool = False
    with_keypoints: bool = False
    num_keypoints: int = 17
    test_short_side: int = 800
    test_max_side: int = 1333


class GeneralizedRCNN(nn.Module):
    def __init__(self, cfg: RCNNConfig, trainable_bn: bool = False):
        super().__init__()
        self.cfg = cfg
        self.backbone = DetectionResNet(
            tuple(cfg.blocks), cfg.groups, cfg.width_per_group,
            TrainBN if trainable_bn else FrozenBN)
        self.fpn = FPN()
        self.rpn = RPN(post_nms_topk=cfg.post_nms_topk)
        self.box_head = BoxHead(cfg.num_classes)
        if cfg.with_masks:
            self.mask_head = (CoarseMaskHead(cfg.num_classes)
                              if cfg.with_pointrend
                              else MaskHead(cfg.num_classes))
        if cfg.with_pointrend:
            self.point_head = PointHead(cfg.num_classes)
        if cfg.with_keypoints:
            self.keypoint_head = KeypointHead(cfg.num_keypoints)
        self.register_buffer("pixel_mean",
                             torch.tensor(PIXEL_MEAN_BGR, dtype=torch.float32),
                             persistent=False)

    def forward(self, image_bgr: torch.Tensor) -> Dict[str, torch.Tensor]:
        """image_bgr [H, W, 3] float (0..255 BGR, resized and padded to a
        multiple of 32) -> static-shape detections, masks refined by
        PointRend where the config has it."""
        h, w, _ = image_bgr.shape
        feats, proposals, prop_valid = self.infer_front(image_bgr)
        det = self.infer_boxes(feats, proposals, prop_valid, (h, w))
        return self.refine(self.infer_tail(feats, *det))

    def pyramid(self, image_bgr: torch.Tensor):
        """image -> [P2, ..., P6] ([1, C, H, W] each)."""
        mean = self.pixel_mean
        if image_bgr.dtype == torch.float64:
            # the JAX package's Python floats, not their float32 roundings
            mean = torch.tensor(PIXEL_MEAN_BGR, dtype=torch.float64,
                                device=image_bgr.device)
        x = (image_bgr - mean)[None].permute(0, 3, 1, 2)
        return self.fpn(self.backbone(x))

    # ---- the trainer's pieces (the targets are assigned outside) --------
    def features(self, image_bgr: torch.Tensor):
        """image [H, W, 3] -> (the pyramid [P2, ..., P6], P2..P5 as a
        :class:`LevelTable` for the ROI heads)."""
        pyramid = self.pyramid(image_bgr)
        return pyramid, LevelTable(
            [p[0].permute(1, 2, 0) for p in pyramid[:4]], STRIDES)

    def rpn_raw(self, pyramid):
        """Per-level objectness logits [H W A] and deltas [H W A, 4], in
        the JAX package's NHWC flatten order."""
        logits, deltas = self.rpn.head(pyramid)
        return ([lg.permute(0, 2, 3, 1).reshape(-1) for lg in logits],
                [dl.permute(0, 2, 3, 1).reshape(-1, 4) for dl in deltas])

    def box_apply(self, feats: LevelTable, rois: torch.Tensor):
        """(class scores [R, K + 1], class deltas [R, 4 K])."""
        return self.box_head(feats.roi_align(rois, 7))

    def mask_apply(self, feats: LevelTable, rois: torch.Tensor):
        """Mask logits [R, 28, 28, K]."""
        return self.mask_head(feats.roi_align(rois, 14))

    def keypoint_apply(self, feats: LevelTable, rois: torch.Tensor):
        """Keypoint heatmaps [R, 56, 56, K]."""
        return self.keypoint_head(feats.roi_align(rois, 14))

    def infer_front(self, image_bgr: torch.Tensor):
        """Backbone, FPN and RPN: (P2..P5 as one :class:`LevelTable` of
        [H, W, C] maps, proposals [post_nms_topk, 4], their validity)."""
        pyramid = self.pyramid(image_bgr)
        proposals, _, prop_valid = self.rpn(pyramid,
                                            tuple(image_bgr.shape[:2]))
        feats = LevelTable([p[0].permute(1, 2, 0) for p in pyramid[:4]],
                           STRIDES)
        return feats, proposals, prop_valid

    def infer_boxes(self, feats: LevelTable, proposals, prop_valid,
                    image_hw: Tuple[int, int]):
        """Box head and class-aware NMS: (boxes, scores, classes, valid)."""
        scores, deltas = self.box_head(feats.roi_align(proposals, 7))
        return box_inference(proposals, prop_valid, scores, deltas,
                             image_hw, self.cfg.score_thresh,
                             self.cfg.nms_thresh, self.cfg.max_detections)

    def infer_tail(self, feats: LevelTable, boxes, det_scores, det_classes,
                   det_valid) -> Dict[str, torch.Tensor]:
        """The mask head (PointRend's coarse head) and the keypoint head on
        the detections (one 14 x 14 ROIAlign for both)."""
        out = {"boxes": boxes, "scores": det_scores, "classes": det_classes,
               "valid": det_valid}
        if self.cfg.with_masks or self.cfg.with_keypoints:
            pooled = feats.roi_align(boxes, 14)
        if self.cfg.with_masks:
            mask_logits = self.mask_head(pooled)
            d, s = mask_logits.shape[:2]
            out["mask_logits"] = mask_logits.gather(
                -1, det_classes.reshape(d, 1, 1, 1).expand(d, s, s, 1))[..., 0]
            if self.cfg.with_pointrend:
                out["p2"] = feats.maps[0]
                out["coarse_all"] = mask_logits
        if self.cfg.with_keypoints:
            out["keypoint_heatmaps"] = self.keypoint_head(pooled)
        return out

    def refine(self, out: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """PointRend's subdivision (3 steps of 784 points) of every
        detection's mask logits, along one leading axis; a config without
        PointRend passes ``out`` through."""
        if "coarse_all" not in out:
            return out
        out = dict(out)
        out["mask_logits"] = pointrend_refine(
            self.point_head, out["mask_logits"], out.pop("coarse_all"),
            out["classes"], out.pop("p2"), out["boxes"], num_subdivisions=3)
        return out


def preprocess_bgr(img_bgr: np.ndarray, short: int, max_side: int,
                   device="cpu") -> Tuple[torch.Tensor, float]:
    """Detectron2's test-time resize (shortest edge, capped; OpenCV's
    uint8 ``INTER_LINEAR``) and padding to a multiple of 32, on ``device``
    (the uint8 frame is uploaded, then resized). Returns (the padded
    float32 image [H, W, 3], the scale)."""
    h, w = img_bgr.shape[:2]
    scale = short / min(h, w)
    if max(h, w) * scale > max_side:
        scale = max_side / max(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    src = torch.from_numpy(np.ascontiguousarray(img_bgr)).to(device)
    ph = -(-nh // 32) * 32
    pw = -(-nw // 32) * 32
    out = torch.zeros((ph, pw, 3), dtype=torch.float32, device=src.device)
    out[:nh, :nw] = cv2_linear_u8(src, (nh, nw))
    return out, scale


def heatmaps_to_keypoints(heatmaps: np.ndarray, boxes: np.ndarray
                          ) -> np.ndarray:
    """[D, S, S, K] heatmaps -> [D, K, 3] (x, y, score) in image
    coordinates: each keypoint at its heatmap's first maximum (numpy's
    ``argmax``), the cell's centre mapped into its box."""
    d, s, _, k = heatmaps.shape
    flat = heatmaps.reshape(d, s * s, k)
    idx = flat.argmax(axis=1)                          # [D, K]
    score = flat.max(axis=1)
    ys = (idx // s + 0.5) / s
    xs = (idx % s + 0.5) / s
    x1 = boxes[:, 0:1]
    y1 = boxes[:, 1:2]
    bw = np.maximum(boxes[:, 2:3] - boxes[:, 0:1], 1e-6)
    bh = np.maximum(boxes[:, 3:4] - boxes[:, 1:2], 1e-6)
    return np.stack([x1 + xs * bw, y1 + ys * bh, score], axis=-1)


def paste_mask(mask_logit: np.ndarray, box: np.ndarray, out_hw,
               thresh: float = 0.5) -> np.ndarray:
    """Paste a square mask logit map into the full image: sigmoid,
    OpenCV's float ``INTER_LINEAR`` to the rounded box, threshold."""
    x1, y1, x2, y2 = [int(round(v)) for v in box]
    x1, y1 = max(x1, 0), max(y1, 0)
    x2 = min(x2, out_hw[1])
    y2 = min(y2, out_hw[0])
    out = np.zeros(out_hw, np.uint8)
    if x2 <= x1 or y2 <= y1:
        return out
    prob = 1.0 / (1.0 + np.exp(-mask_logit))
    resized = cv2_linear_f32(prob, (y2 - y1, x2 - x1))
    out[y1:y2, x1:x2] = (resized > thresh).astype(np.uint8)
    return out


class Detector:
    """The pipeline's detector: a BGR uint8 image -> :class:`Instances`.
    :meth:`preprocess` and :meth:`postprocess` run on the host,
    :meth:`forward` on the model's device."""

    def __init__(self, model: GeneralizedRCNN):
        self.cfg = model.cfg
        self.model = model.eval()
        self.device = model.pixel_mean.device

    def preprocess(self, img_bgr: np.ndarray) -> Tuple[torch.Tensor, float]:
        return preprocess_bgr(img_bgr, self.cfg.test_short_side,
                              self.cfg.test_max_side, self.device)

    def forward(self, padded: torch.Tensor) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            return self.model(padded)

    def postprocess(self, out: Dict[str, np.ndarray], scale: float,
                    hw: Tuple[int, int]):
        from ...pipelines.object_detection import Instances
        n = int(out["valid"].sum())
        boxes = out["boxes"] / np.float32(scale)
        masks = None
        if "mask_logits" in out:
            masks = np.zeros((n,) + tuple(hw), np.uint8)
            for i in range(n):
                masks[i] = paste_mask(out["mask_logits"][i], boxes[i], hw)
        keypoints = None
        if "keypoint_heatmaps" in out:
            keypoints = heatmaps_to_keypoints(out["keypoint_heatmaps"][:n],
                                              boxes[:n])
        return Instances(boxes=boxes[:n], scores=out["scores"][:n],
                         classes=out["classes"][:n].astype(np.int32),
                         masks=masks, keypoints=keypoints)

    def __call__(self, img_bgr: np.ndarray):
        padded, scale = self.preprocess(img_bgr)
        out = {k: v.cpu().numpy() for k, v in self.forward(padded).items()}
        return self.postprocess(out, scale, img_bgr.shape[:2])


def build_detector(model: GeneralizedRCNN) -> Detector:
    """The detector of a model that holds its weights on its device (the
    JAX package's takes a config and variables and builds the model)."""
    return Detector(model)


def stopsign_rcnn_config() -> RCNNConfig:
    """PointRend X-101-32x8d instance segmentation (stop signs)."""
    return RCNNConfig(groups=32, width_per_group=8, score_thresh=0.5,
                      with_masks=True, with_pointrend=True)


def keypoint_rcnn_config() -> RCNNConfig:
    """Keypoint R-CNN R-101 (people)."""
    return RCNNConfig(groups=1, width_per_group=64, score_thresh=0.7,
                      num_classes=1, with_keypoints=True)


def _sidecar_config(path: str) -> Optional[RCNNConfig]:
    """:class:`RCNNConfig` from a ``rcnn_config.json`` sidecar next to (or
    inside) a checkpoint."""
    for cand in (os.path.join(path, "rcnn_config.json"),
                 os.path.join(os.path.dirname(path.rstrip("/")),
                              "rcnn_config.json")):
        if os.path.exists(cand):
            with open(cand) as f:
                d = json.load(f)
            if "blocks" in d:
                d["blocks"] = tuple(d["blocks"])
            d.pop("jit_split", None)
            return RCNNConfig(**d)
    return None


# Detectron2's initial standard deviations of the prediction layers
_PREDICTOR_STD = {"rpn.head.objectness": 0.01, "rpn.head.deltas": 0.01,
                  "box_head.cls": 0.01, "box_head.bbox": 0.001,
                  "mask_head.predictor": 0.001,
                  "mask_head.prediction": 0.001,
                  "point_head.predictor": 0.001}
# the stem sees BGR less its mean, about +-128, unscaled (Detectron2's
# MSRA-style input)
_STEM_SCALE = 1.0 / 64


def seeded_init(model: nn.Module, seed: int = 0) -> nn.Module:
    """Deterministic weights from ``seed``, made on the CPU whatever the
    model's device (so a card and a CPU copy agree), that keep a random
    detector's numbers in a trained one's ranges: convolution and linear
    weights normal with variance 1 / fan-in (LeCun), the stem's divided by
    64 for the unscaled pixels, the prediction layers normal with
    Detectron2's standard deviations (0.01 for scores, 0.001 for box and
    mask deltas), so proposals stay near their anchors; biases zero;
    FrozenBN the identity."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, mod in model.named_modules():
            if not isinstance(mod, (nn.Conv2d, nn.Linear,
                                    nn.ConvTranspose2d)):
                continue
            w = mod.weight
            fan_in = w.shape[0] * w[0, 0].numel() if isinstance(
                mod, nn.ConvTranspose2d) else w[0].numel()
            std = _PREDICTOR_STD.get(name, fan_in ** -0.5)
            if name == "backbone.stem_conv":
                std *= _STEM_SCALE
            w.copy_(torch.randn(w.shape, generator=gen) * std)
            if mod.bias is not None:
                mod.bias.zero_()
    return model


def load_default_detector(opt: str, model_path: Optional[str] = None,
                          device="cuda") -> Detector:
    """The detector for ``--opt stopsign`` or ``--opt people``. Weights:
    ``model_path``, else ``records/pointrend_x101_tpu`` (stop signs) or
    ``records/keypoint_r101_tpu`` (people), else the bundled tiny
    checkpoint (``records/checkpoints/{stopsign,people}_tiny/best.npz``);
    a flat ``.npz`` of the JAX package goes through
    :func:`convert_rcnn_variables`, its ``rcnn_config.json`` sidecar
    choosing the configuration (default: :func:`stopsign_rcnn_config` or
    :func:`keypoint_rcnn_config`). An orbax directory raises. Without any
    checkpoint, seeded weights with a warning (smoke mode)."""
    from ...core.checkpoint import load_flat_npz
    from ...core.convert import convert_rcnn_variables

    defaults = {"stopsign": ("pointrend_x101_tpu", "stopsign_tiny",
                             stopsign_rcnn_config),
                "people": ("keypoint_r101_tpu", "people_tiny",
                           keypoint_rcnn_config)}
    if opt not in defaults:
        raise ValueError(f"unknown detection option {opt!r}")
    default_dir, tiny, default_cfg = defaults[opt]
    device = resolve_device(device)
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    path = model_path or os.path.join(repo, "records", default_dir)
    if (not model_path or not os.path.exists(model_path)) and \
            not os.path.exists(path):
        demo = os.path.join(repo, "records", "checkpoints", tiny, "best.npz")
        if os.path.exists(demo):
            path = demo
    cfg = _sidecar_config(path) or default_cfg()
    model = GeneralizedRCNN(cfg)
    if path.endswith(".npz") and os.path.exists(path):
        model.load_state_dict(convert_rcnn_variables(load_flat_npz(path)))
    elif os.path.isdir(path):
        raise ValueError(f"{path} is an orbax checkpoint directory; the port "
                         "reads flat .npz files only")
    else:
        warnings.warn(f"No detector checkpoint at {path!r}; seeded weights "
                      "(smoke mode).")
        seeded_init(model, 0)
    return build_detector(model.to(device))
