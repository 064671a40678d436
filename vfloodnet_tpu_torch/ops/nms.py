"""Greedy non-maximum suppression with a static output size, and
``jax.lax.top_k``'s order (counterpart of ``vfloodnet_tpu.ops.nms``).

:func:`nms_plain` is the JAX package's loop: ``max_out`` steps, each
picking the highest alive score (the first index among equal ones) and
suppressing every box whose IoU with it exceeds the threshold, and the
pick itself. It runs on the CPU and in the tests. :func:`nms` takes it for
a CPU tensor only; a CUDA tensor goes to the kernel of ``csrc/nms.cu``
(:mod:`.nms_cuda`), which gives the same three outputs in one launch set
and no host sync.

:func:`top_k` is ``jax.lax.top_k``: the ``k`` largest values in descending
order, the lower index first among equal values. ``torch.topk`` promises
no order among ties on the card, so it ranks int64 keys of (ordered float
bits << 32 | ~index), which are all distinct.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import nms_cuda


def _ordered_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 of the float32 ``x`` whose order is the values' total order:
    -0.0 below +0.0, as ``jax.lax.top_k`` ranks them."""
    bits = x.float().contiguous().view(torch.int32)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the ``k`` largest entries of the last axis of
    a float tensor, descending, ties to the lower index."""
    n = x.shape[-1]
    low = (0xFFFFFFFF - torch.arange(n, device=x.device, dtype=torch.int64))
    key = (_ordered_bits(x) << 32) | low
    idx = torch.topk(key, k, dim=-1, largest=True, sorted=True).indices
    return x.gather(-1, idx), idx


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU matrix between [N, 4] and [M, 4] xyxy boxes (the JAX package's
    float32 operations in its order)."""
    area_a = (a[:, 2] - a[:, 0]).clamp(min=0) * (a[:, 3] - a[:, 1]).clamp(
        min=0)
    area_b = (b[:, 2] - b[:, 0]).clamp(min=0) * (b[:, 3] - b[:, 1]).clamp(
        min=0)
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / union.clamp(min=1e-9)


def nms_plain(boxes: torch.Tensor, scores: torch.Tensor,
              iou_threshold: float, max_out: int,
              score_threshold: float = 0.0
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: (keep_idx [max_out] int64, clamped to
    0 where absent, keep_scores [max_out] with -inf where absent, valid
    [max_out] bool)."""
    n = boxes.shape[0]
    dev = boxes.device
    out_idx = torch.full((max_out,), -1, dtype=torch.int64, device=dev)
    out_score = torch.full((max_out,), float("-inf"), device=dev)
    if n == 0:
        return out_idx.clamp(min=0), out_score, out_idx >= 0
    boxes, scores = boxes.float(), scores.float()
    iou = box_iou(boxes, boxes)
    alive = scores > score_threshold
    ar = torch.arange(n, device=dev)
    neg = torch.full_like(scores, float("-inf"))
    for i in range(max_out):
        s = torch.where(alive, scores, neg)
        best = torch.argmax(s)
        best_score = s[best]
        ok = torch.isfinite(best_score)
        out_idx[i] = torch.where(ok, best, -1)
        out_score[i] = torch.where(ok, best_score, float("-inf"))
        suppress = (iou[best] > iou_threshold) | (ar == best)
        alive = torch.where(ok, alive & ~suppress, alive)
    valid = out_idx >= 0
    return out_idx.clamp(min=0), out_score, valid


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
        max_out: int, score_threshold: float = 0.0
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy NMS with a static output size (see :func:`nms_plain`): the
    kernel on CUDA tensors, the plain version on CPU ones."""
    if boxes.is_cuda:
        return nms_cuda.nms(boxes, scores, iou_threshold, max_out,
                            score_threshold)
    return nms_plain(boxes, scores, iou_threshold, max_out, score_threshold)


def batched_class_nms(boxes: torch.Tensor, scores: torch.Tensor,
                      classes: torch.Tensor, iou_threshold: float,
                      max_out: int, score_threshold: float = 0.0):
    """Class-aware NMS by the coordinate-offset trick (boxes of different
    classes never overlap)."""
    span = boxes.max() + 1.0
    offset = classes.to(boxes.dtype)[:, None] * span
    return nms(boxes + offset, scores, iou_threshold, max_out,
               score_threshold)
