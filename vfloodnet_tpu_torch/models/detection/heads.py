"""ROI heads (counterpart of ``vfloodnet_tpu.models.detection.heads``): the
box head, the mask head, PointRend's coarse mask head and point head, the
keypoint head, box inference and PointRend's subdivision. Static shapes
throughout: a fixed detection count with a validity mask.

ROI features stay in the JAX package's [R, S, S, C] layout, so the fully
connected heads flatten them in its (y, x, channel) order and take its
weights unpermuted; only the mask head's convolutions run NCHW.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.nms import nms, top_k
from ...ops.resize import resize
from ...ops.roi_align import bilinear_sample
from .rpn import clip_boxes, decode_boxes

BOX_REG_WEIGHTS = (10.0, 10.0, 5.0, 5.0)   # Detectron2 ROI box transform


class BoxHead(nn.Module):
    """ROIAlign 7x7 -> 2 x FC(1024) -> class scores + class deltas."""

    def __init__(self, num_classes: int = 80, in_channels: int = 256,
                 pooled: int = 7, fc_dim: int = 1024):
        super().__init__()
        self.fc1 = nn.Linear(pooled * pooled * in_channels, fc_dim)
        self.fc2 = nn.Linear(fc_dim, fc_dim)
        self.cls = nn.Linear(fc_dim, num_classes + 1)
        self.bbox = nn.Linear(fc_dim, num_classes * 4)

    def forward(self, pooled: torch.Tensor):      # [R, 7, 7, C]
        h = F.relu(self.fc1(pooled.reshape(pooled.shape[0], -1)))
        h = F.relu(self.fc2(h))
        return self.cls(h), self.bbox(h)


class MaskHead(nn.Module):
    """4 x conv(256) + 2x deconvolution + 1x1 -> [R, 28, 28, K] logits.

    The Flax transposed convolution (2x2, stride 2, its default padding,
    kernel not transposed) writes input pixel (i, j) times kernel tap
    (1 - a, 1 - b) to output (2i + a, 2j + b); ``nn.ConvTranspose2d``
    uses tap (a, b). The weight bridge flips the kernel spatially."""

    def __init__(self, num_classes: int = 80, in_channels: int = 256,
                 conv_dim: int = 256, num_conv: int = 4):
        super().__init__()
        self.num_conv = num_conv
        for i in range(num_conv):
            self.add_module(f"conv{i}", nn.Conv2d(
                in_channels if i == 0 else conv_dim, conv_dim, 3, padding=1))
        self.deconv = nn.ConvTranspose2d(conv_dim, conv_dim, 2, stride=2)
        self.predictor = nn.Conv2d(conv_dim, num_classes, 1)

    def forward(self, pooled: torch.Tensor) -> torch.Tensor:   # [R, S, S, C]
        h = pooled.permute(0, 3, 1, 2)
        for i in range(self.num_conv):
            h = F.relu(getattr(self, f"conv{i}")(h))
        h = F.relu(self.deconv(h))
        return self.predictor(h).permute(0, 2, 3, 1)


class CoarseMaskHead(nn.Module):
    """PointRend's coarse head: a 1x1 channel reduction, flatten, 2 FCs,
    FC -> [R, 7, 7, K] logits. The 1x1 convolution acts on the channels
    of the [R, 14, 14, C] features in place (a product over C)."""

    def __init__(self, num_classes: int = 80, in_channels: int = 256,
                 pooled: int = 14, conv_dim: int = 256, fc_dim: int = 1024,
                 output_side: int = 7):
        super().__init__()
        self.reduce = nn.Conv2d(in_channels, conv_dim, 1)
        self.fc1 = nn.Linear(pooled * pooled * conv_dim, fc_dim)
        self.fc2 = nn.Linear(fc_dim, fc_dim)
        self.prediction = nn.Linear(
            fc_dim, num_classes * output_side * output_side)
        self.output_side = output_side
        self.num_classes = num_classes

    def forward(self, pooled: torch.Tensor) -> torch.Tensor:
        r = pooled.shape[0]
        w = self.reduce.weight
        h = F.relu(F.linear(pooled, w.reshape(w.shape[0], -1),
                            self.reduce.bias))
        h = F.relu(self.fc1(h.reshape(r, -1)))
        h = F.relu(self.fc2(h))
        s = self.output_side
        return self.prediction(h).reshape(r, s, s, self.num_classes)


class PointHead(nn.Module):
    """PointRend's point head: an MLP over (fine feature, coarse logits)
    per point, the coarse logits appended again after every layer."""

    def __init__(self, num_classes: int = 80, in_channels: int = 256,
                 fc_dim: int = 256, num_fc: int = 3):
        super().__init__()
        self.num_fc = num_fc
        for i in range(num_fc):
            self.add_module(f"fc{i}", nn.Linear(
                (in_channels if i == 0 else fc_dim) + num_classes, fc_dim))
        self.predictor = nn.Linear(fc_dim + num_classes, num_classes)

    def forward(self, fine: torch.Tensor, coarse: torch.Tensor):
        """fine [R, P, C], coarse [R, P, K] -> logits [R, P, K]."""
        h = torch.cat([fine, coarse], dim=-1)
        for i in range(self.num_fc):
            h = F.relu(getattr(self, f"fc{i}")(h))
            h = torch.cat([h, coarse], dim=-1)
        return self.predictor(h)


class KeypointHead(nn.Module):
    """8 x conv(512) + a 4x4 stride-2 deconvolution + a 2x linear upsample
    -> [R, 56, 56, K] heatmaps (K = 17 COCO keypoints).

    The Flax ``ConvTranspose`` (4x4, stride 2, padding "SAME") pads the
    stride-dilated input by (2, 2) and correlates it with the kernel
    unflipped: ``ConvTranspose2d(k=4, s=2, p=1)`` with the kernel flipped
    spatially (the weight bridge flips it), 14 -> 28. The upsample is
    ``jax.image.resize``'s ``linear`` (half-pixel centres), 28 -> 56."""

    def __init__(self, num_keypoints: int = 17, in_channels: int = 256,
                 conv_dim: int = 512, num_conv: int = 8):
        super().__init__()
        self.num_conv = num_conv
        for i in range(num_conv):
            self.add_module(f"conv{i}", nn.Conv2d(
                in_channels if i == 0 else conv_dim, conv_dim, 3, padding=1))
        self.deconv = nn.ConvTranspose2d(conv_dim, num_keypoints, 4,
                                         stride=2, padding=1)

    def forward(self, pooled: torch.Tensor) -> torch.Tensor:   # [R, S, S, C]
        h = pooled.permute(0, 3, 1, 2)
        for i in range(self.num_conv):
            h = F.relu(getattr(self, f"conv{i}")(h))
        h = self.deconv(h).permute(0, 2, 3, 1)
        s = 2 * h.shape[1]
        return resize(h, (s, s), method="bilinear")


def box_inference(proposals: torch.Tensor, prop_valid: torch.Tensor,
                  scores: torch.Tensor, deltas: torch.Tensor,
                  image_hw: Tuple[int, int], score_thresh: float,
                  nms_thresh: float = 0.5, max_det: int = 100):
    """Detectron2's FastRCNNOutputs inference with static shapes:
    per-class decoding, the score threshold, a top-k cap of 2,048
    candidates (``jax.lax.top_k``'s order: every score at or under the
    threshold is 0.0, so thousands tie), class-aware NMS by coordinate
    offsets, ``max_det`` kept. Returns (boxes [D, 4], scores [D], classes
    [D], valid [D])."""
    r, k1 = scores.shape
    k = k1 - 1
    probs = torch.softmax(scores.float(), dim=-1)[:, :k]
    deltas = deltas.reshape(r, k, 4).float()
    boxes_k = decode_boxes(proposals[:, None, :].expand(r, k, 4), deltas,
                           weights=BOX_REG_WEIGHTS)
    flat_boxes = clip_boxes(boxes_k, image_hw).reshape(r * k, 4)
    zero = torch.zeros((), device=probs.device)
    flat_scores = torch.where(prop_valid[:, None], probs, zero).reshape(-1)
    flat_classes = torch.arange(k, device=probs.device).repeat(r)
    flat_scores = torch.where(flat_scores > score_thresh, flat_scores, zero)
    cap = min(2048, r * k)
    top_scores, top_idx = top_k(flat_scores, cap)
    cand_boxes = flat_boxes.index_select(0, top_idx)
    cand_classes = flat_classes.index_select(0, top_idx)
    span = torch.clamp(cand_boxes.max(), min=float(max(image_hw))) + 1.0
    offset_boxes = cand_boxes + cand_classes[:, None].float() * span
    keep_idx, _, valid = nms(offset_boxes, top_scores, nms_thresh, max_det,
                             score_threshold=score_thresh)
    return (cand_boxes.index_select(0, keep_idx),
            torch.where(valid, top_scores.index_select(0, keep_idx), zero),
            cand_classes.index_select(0, keep_idx), valid)


def pointrend_refine(point_head: PointHead, coarse_sel: torch.Tensor,
                     coarse_all: torch.Tensor, det_class: torch.Tensor,
                     fine_feat: torch.Tensor, boxes: torch.Tensor,
                     num_subdivisions: int = 3,
                     points_per_step: int = 784) -> torch.Tensor:
    """PointRend's subdivision for every detection at once (the JAX
    package vmaps one detection's over them): ``num_subdivisions`` times,
    upsample the selected-class logits 2x (``jax.image.resize`` linear)
    and re-predict the ``points_per_step`` most uncertain points (top-k of
    -|logit|, ties to the lower index) with the point head, fed the P2
    feature and every class's coarse logit at each point.

    coarse_sel [D, M, M]; coarse_all [D, M, M, K]; det_class [D] int;
    fine_feat [H, W, C] (P2, stride 4); boxes [D, 4] xyxy. Returns the
    refined selected-class logits [D, M 2^n, M 2^n]."""
    logits = coarse_sel
    d, m0 = coarse_all.shape[0], coarse_all.shape[1]
    n_cls = coarse_all.shape[-1]
    x1, y1, x2, y2 = (boxes[:, i:i + 1] for i in range(4))
    bw = torch.clamp(x2 - x1, min=1e-6)
    bh = torch.clamp(y2 - y1, min=1e-6)
    h, w, c = fine_feat.shape
    fine_flat = fine_feat.reshape(h * w, c)
    coarse_flat = coarse_all.reshape(d * m0 * m0, n_cls)
    coarse_base = torch.arange(d, device=boxes.device) * (m0 * m0)
    for _ in range(num_subdivisions):
        m2 = logits.shape[-1] * 2
        logits = resize(logits, (m2, m2), method="bilinear",
                        spatial_axes=(-2, -1))
        k = min(points_per_step, m2 * m2)
        _, idx = top_k(-logits.abs().reshape(d, -1), k)     # [D, k]
        py = torch.div(idx, m2, rounding_mode="floor").float()
        px = (idx % m2).float()
        u = (px + 0.5) / m2
        v = (py + 0.5) / m2
        img_x = x1 + u * bw
        img_y = y1 + v * bh
        # normalised to the image (P2 x 4), then P2's sample positions, as
        # the JAX package's point_sample computes them
        pts_x = img_x / (w * 4.0)
        pts_y = img_y / (h * 4.0)
        fine = bilinear_sample(fine_flat, 0, h, w, pts_y * h - 0.5,
                               pts_x * w - 0.5)                  # [D, k, C]
        coarse_pts = bilinear_sample(coarse_flat, coarse_base, m0, m0,
                                     v * m0 - 0.5, u * m0 - 0.5)  # [D, k, K]
        refined = point_head(fine, coarse_pts)                   # [D, k, K]
        sel = refined.gather(-1, det_class.reshape(d, 1, 1).expand(
            d, k, 1))[..., 0]
        logits = logits.reshape(d, -1).scatter(1, idx, sel).reshape(
            d, m2, m2)
    return logits
