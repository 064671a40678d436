"""Region Proposal Network over P2-P6, static shapes (counterpart of
``vfloodnet_tpu.models.detection.rpn``): one 3x3 trunk, per-anchor
objectness and deltas, a top-k of 1,000 a level (``jax.lax.top_k``'s
order), delta decoding, clipping, NMS(0.7) and 1,000 proposals with a
validity mask.

The NMS keeps only positive objectness logits: the JAX package calls it
with its default ``score_threshold=0.0``. Detectron2 does not filter so;
the port keeps the reference's behaviour.
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.nms import nms, top_k

ANCHOR_SIZES = (32, 64, 128, 256, 512)
ASPECT_RATIOS = (0.5, 1.0, 2.0)
RPN_STRIDES = (4, 8, 16, 32, 64)


@functools.lru_cache(maxsize=32)
def generate_anchors(h: int, w: int, stride: int, size: int,
                     device: torch.device = torch.device("cpu"),
                     ratios: Sequence[float] = ASPECT_RATIOS,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Anchor boxes [h*w*A, 4] xyxy centred on each cell, made on
    ``device`` (no host copy) once per size, in ``dtype``."""
    ys = (torch.arange(h, device=device, dtype=dtype) + 0.5) * stride
    xs = (torch.arange(w, device=device, dtype=dtype) + 0.5) * stride
    cy, cx = torch.meshgrid(ys, xs, indexing="ij")
    anchors = []
    area = float(size * size)
    for r in ratios:
        aw = (area / r) ** 0.5
        ah = aw * r
        anchors.append(torch.stack([cx - aw / 2, cy - ah / 2,
                                    cx + aw / 2, cy + ah / 2], dim=-1))
    return torch.stack(anchors, dim=2).reshape(-1, 4)


def decode_boxes(anchors: torch.Tensor, deltas: torch.Tensor,
                 weights=(1.0, 1.0, 1.0, 1.0),
                 scale_clamp: float = 4.135) -> torch.Tensor:
    """Apply (dx, dy, dw, dh) deltas [..., 4] to anchors [..., 4]
    (Detectron2's Box2BoxTransform)."""
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    ax = anchors[..., 0] + aw / 2
    ay = anchors[..., 1] + ah / 2
    wx, wy, ww, wh = weights
    dx, dy = deltas[..., 0] / wx, deltas[..., 1] / wy
    dw = torch.clamp(deltas[..., 2] / ww, -scale_clamp, scale_clamp)
    dh = torch.clamp(deltas[..., 3] / wh, -scale_clamp, scale_clamp)
    cx = ax + dx * aw
    cy = ay + dy * ah
    w = aw * torch.exp(dw)
    h = ah * torch.exp(dh)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                       dim=-1)


def clip_boxes(boxes: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    hh, ww = hw
    return torch.stack([boxes[..., 0].clamp(0, ww), boxes[..., 1].clamp(0, hh),
                        boxes[..., 2].clamp(0, ww), boxes[..., 3].clamp(0, hh)],
                       dim=-1)


class RPNHead(nn.Module):
    def __init__(self, channels: int = 256,
                 num_anchors: int = len(ASPECT_RATIOS)):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)
        self.objectness = nn.Conv2d(channels, num_anchors, 1)
        self.deltas = nn.Conv2d(channels, num_anchors * 4, 1)

    def forward(self, feats: Sequence[torch.Tensor]):
        logits, deltas = [], []
        for f in feats:
            t = F.relu(self.conv(f))
            logits.append(self.objectness(t))
            deltas.append(self.deltas(t))
        return logits, deltas


class RPN(nn.Module):
    def __init__(self, pre_nms_topk: int = 1000, post_nms_topk: int = 1000,
                 nms_thresh: float = 0.7):
        super().__init__()
        self.pre_nms_topk = pre_nms_topk
        self.post_nms_topk = post_nms_topk
        self.nms_thresh = nms_thresh
        self.head = RPNHead()

    def forward(self, feats: Sequence[torch.Tensor],
                image_hw: Tuple[int, int]):
        """feats: P2..P6 ([1, C, H, W] each). Returns (proposals
        [post_nms_topk, 4], scores, valid)."""
        logits, deltas = self.head(feats)
        all_boxes: List[torch.Tensor] = []
        all_scores: List[torch.Tensor] = []
        for lvl, (lg, dl) in enumerate(zip(logits, deltas)):
            _, _, h, w = lg.shape
            anchors = generate_anchors(h, w, RPN_STRIDES[lvl],
                                       ANCHOR_SIZES[lvl], lg.device)
            # NHWC order, as the JAX package flattens
            scores = lg.permute(0, 2, 3, 1).reshape(-1).float()
            dl = dl.permute(0, 2, 3, 1).reshape(-1, 4).float()
            k = min(self.pre_nms_topk, scores.shape[0])
            top_scores, top_idx = top_k(scores, k)
            boxes = decode_boxes(anchors.index_select(0, top_idx),
                                 dl.index_select(0, top_idx))
            all_boxes.append(clip_boxes(boxes, image_hw))
            all_scores.append(top_scores)
        boxes = torch.cat(all_boxes)
        scores = torch.cat(all_scores)
        ok = ((boxes[:, 2] - boxes[:, 0]) > 1e-3) & \
            ((boxes[:, 3] - boxes[:, 1]) > 1e-3)
        scores = torch.where(ok, scores, torch.full_like(scores,
                                                         float("-inf")))
        keep_idx, keep_scores, valid = nms(boxes, scores, self.nms_thresh,
                                           self.post_nms_topk)
        return boxes.index_select(0, keep_idx), keep_scores, valid
