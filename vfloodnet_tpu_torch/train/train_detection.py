"""Generalized R-CNN trainer (counterpart of
``vfloodnet_tpu.train.train_detection``): RPN, box, mask and keypoint
losses on single-image steps, and the loops of the JAX package's
``scripts/train_demo_detector.py`` and ``scripts/train_people_chain.py``
detector stage.

Detectron2's loss structure, with static shapes:

- RPN: balanced sigmoid BCE on anchor objectness (positive at IoU >= 0.7,
  negative under 0.3, ignored between, and each valid GT's best anchor
  forced positive by a scatter-max), L1 on the positive anchors' deltas;
- ROI box head: softmax CE over K + 1 classes (background at index K),
  class-specific L1 on the foreground deltas, weights (10, 10, 5, 5);
- mask head: per-class BCE at 28 x 28 on the foreground ROIs, targets the
  GT masks cropped by the same ROIAlign;
- keypoint head: per-visible-keypoint softmax CE over the heatmap grid of
  the first ``keypoint_rois`` foreground ROIs, a keypoint on the ROI's
  right or bottom edge clamped into the last bin.

Training proposals are NMS-free: the GT boxes, the top-k decoded anchors
and uniform random boxes. JAX draws the random boxes from its keys, which
cannot be reproduced without JAX: here they come from a
``torch.Generator`` on the CPU seeded by (seed, step), and
:func:`detection_loss` takes them as an argument, so tests can pass JAX's.
The model is ``GeneralizedRCNN(cfg, trainable_bn=True)``; its BNs' scale
and bias train, their statistics stay. The optimiser is
:class:`.train_video.AdamWClip` without clip, ``optax.adamw``'s
arithmetic.

Run ``python -m vfloodnet_tpu_torch.train.train_detection --opt
{stopsign,people} --steps N --out DIR [--device cpu]``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core import resolve_device
from ..models.detection.heads import BOX_REG_WEIGHTS
from ..models.detection.meta import (GeneralizedRCNN, RCNNConfig,
                                     seeded_init)
from ..models.detection.rpn import (ANCHOR_SIZES, RPN_STRIDES, decode_boxes,
                                    generate_anchors)
from ..ops.nms import top_k
from ..ops.roi_align import roi_align
from .train_video import AdamWClip, _cross_entropy


@dataclasses.dataclass
class DetectionTrainConfig:
    lr: float = 1e-3
    weight_decay: float = 1e-4
    image_size: int = 320
    roi_n: int = 128           # ROIs per step (gt + topk + random)
    roi_topk: int = 64
    rpn_pos_iou: float = 0.7
    rpn_neg_iou: float = 0.3
    roi_fg_iou: float = 0.5
    mask_weight: float = 1.0
    keypoint_weight: float = 1.0
    keypoint_rois: int = 16    # fg ROIs fed to the keypoint head per step
    epochs: int = 8
    seed: int = 0


def pairwise_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [N, 4], b [M, 4] xyxy -> IoU [N, M]."""
    area_a = (a[:, 2] - a[:, 0]).clamp(min=0) * (a[:, 3] - a[:, 1]).clamp(
        min=0)
    area_b = (b[:, 2] - b[:, 0]).clamp(min=0) * (b[:, 3] - b[:, 1]).clamp(
        min=0)
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area_a[:, None] + area_b[None] - inter).clamp(min=1e-9)


def encode_boxes(gt: torch.Tensor, anchors: torch.Tensor,
                 weights=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """The inverse of ``rpn.decode_boxes``: (dx, dy, dw, dh) targets."""
    aw = (anchors[:, 2] - anchors[:, 0]).clamp(min=1e-6)
    ah = (anchors[:, 3] - anchors[:, 1]).clamp(min=1e-6)
    ax = anchors[:, 0] + aw / 2
    ay = anchors[:, 1] + ah / 2
    gw = (gt[:, 2] - gt[:, 0]).clamp(min=1e-6)
    gh = (gt[:, 3] - gt[:, 1]).clamp(min=1e-6)
    gx = gt[:, 0] + gw / 2
    gy = gt[:, 1] + gh / 2
    wx, wy, ww, wh = weights
    return torch.stack([wx * (gx - ax) / aw, wy * (gy - ay) / ah,
                        ww * torch.log(gw / aw), wh * torch.log(gh / ah)],
                       dim=1)


def level_anchors(image_size: int, device="cpu",
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """All levels' anchors [A, 4] in the order :meth:`rpn_raw` flattens
    its outputs."""
    out = []
    for stride, size in zip(RPN_STRIDES, ANCHOR_SIZES):
        side = -(-image_size // stride)
        out.append(generate_anchors(side, side, stride, size,
                                    torch.device(device), dtype=dtype))
    return torch.cat(out)


def assign_rpn_targets(anchors: torch.Tensor, gt: torch.Tensor,
                       gt_valid: torch.Tensor, pos_iou: float,
                       neg_iou: float):
    """-> (labels [A] in {-1 ignore, 0 negative, 1 positive}, target
    deltas [A, 4]). Each valid GT's best anchor (the first on ties) is
    forced positive by a scatter-max in which an invalid GT's -10 never
    wins."""
    iou = pairwise_iou(anchors, gt) * gt_valid[None, :]
    best = iou.max(dim=1).values
    arg = iou.argmax(dim=1)
    one, zero, ign = (torch.ones_like(arg), torch.zeros_like(arg),
                      torch.full_like(arg, -1))
    labels = torch.where(best >= pos_iou, one,
                         torch.where(best < neg_iou, zero, ign))
    best_anchor = iou.argmax(dim=0)
    forced = torch.where(gt_valid > 0, 1, -10).to(labels.dtype)
    labels = labels.scatter_reduce(0, best_anchor, forced, "amax")
    return labels, encode_boxes(gt[arg], anchors)


def assign_roi_targets(rois: torch.Tensor, gt: torch.Tensor,
                       gt_classes: torch.Tensor, gt_valid: torch.Tensor,
                       num_classes: int, fg_iou: float):
    """-> (class target [R], background = ``num_classes``; foreground
    [R]; matched GT index [R]; target deltas [R, 4])."""
    iou = pairwise_iou(rois, gt) * gt_valid[None, :]
    best = iou.max(dim=1).values
    arg = iou.argmax(dim=1)
    fg = best >= fg_iou
    cls = torch.where(fg, gt_classes.long()[arg],
                      torch.full_like(arg, num_classes))
    return cls, fg, arg, encode_boxes(gt[arg], rois, BOX_REG_WEIGHTS)


def random_boxes(seed: int, step: int, n: int, image_size: int,
                 device="cpu", dtype: torch.dtype = torch.float32
                 ) -> torch.Tensor:
    """``n`` uniform random boxes [n, 4]: a corner in [0, 0.8 S)^2 and a
    size in [0.05 S, 0.5 S)^2, cut at the image's edge, drawn on the CPU
    from a generator seeded by (seed, step), so a step draws the same
    boxes on every device."""
    gen = torch.Generator().manual_seed(int(np.random.SeedSequence(
        [seed, step]).generate_state(1, np.uint64)[0] >> 1))
    u = torch.rand((n, 4), generator=gen, dtype=torch.float64)
    xy = u[:, :2] * (image_size * 0.8)
    wh = image_size * 0.05 + u[:, 2:] * (image_size * 0.45)
    boxes = torch.cat([xy, torch.clamp(xy + wh, max=image_size)], dim=1)
    return boxes.to(device=device, dtype=dtype)


def _training_proposals(anchors, logits_flat, deltas_flat, gt, gt_valid,
                        image_size: int, topk: int,
                        rand_boxes: torch.Tensor) -> torch.Tensor:
    """GT boxes (an invalid slot as the full image, which matches no GT)
    + the top-k decoded anchors + the random boxes -> [R, 4]."""
    _, idx = top_k(logits_flat.detach(), topk)
    top = decode_boxes(anchors[idx], deltas_flat.detach()[idx])
    top = top.clamp(0, image_size)
    full = torch.tensor([0.0, 0.0, image_size, image_size], dtype=gt.dtype,
                        device=gt.device)
    gt_boxes = torch.where(gt_valid[:, None] > 0, gt, full)
    return torch.cat([gt_boxes, top, rand_boxes])


def _sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor
                 ) -> torch.Tensor:
    """optax's ``sigmoid_binary_cross_entropy``."""
    return -labels * F.logsigmoid(logits) - (1 - labels) * F.logsigmoid(
        -logits)


def detection_loss(model: GeneralizedRCNN, cfg: DetectionTrainConfig,
                   anchors: torch.Tensor, image: torch.Tensor,
                   gt_boxes: torch.Tensor, gt_classes: torch.Tensor,
                   gt_masks: torch.Tensor, gt_valid: torch.Tensor,
                   gt_keypoints: Optional[torch.Tensor] = None,
                   rand_boxes: Optional[torch.Tensor] = None, step: int = 0
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The single-image loss and its terms. image [S, S, 3] BGR 0..255;
    gt_boxes [G, 4], gt_classes [G], gt_masks [G, S, S], gt_valid [G];
    ``gt_keypoints`` [G, K, 3] (x, y, visibility) adds the keypoint loss
    for a model with keypoints. ``rand_boxes`` [roi_n - topk - G, 4] are
    the random proposals (default: :func:`random_boxes` of (cfg.seed,
    ``step``))."""
    tc, mc = cfg, model.cfg
    s = image.shape[0]
    pyramid, feats = model.features(image)
    logits, deltas = model.rpn_raw(pyramid)
    logits_flat = torch.cat(logits)
    deltas_flat = torch.cat(deltas)

    # ---- RPN ------------------------------------------------------------
    labels, tgt_deltas = assign_rpn_targets(
        anchors, gt_boxes, gt_valid, tc.rpn_pos_iou, tc.rpn_neg_iou)
    pos = (labels == 1).to(logits_flat.dtype)
    neg = (labels == 0).to(logits_flat.dtype)
    bce = _sigmoid_bce(logits_flat, pos)
    rpn_obj = 0.5 * ((bce * pos).sum() / pos.sum().clamp(min=1.0)
                     + (bce * neg).sum() / neg.sum().clamp(min=1.0))
    l1 = (deltas_flat - tgt_deltas).abs().sum(dim=1)
    rpn_box = (l1 * pos).sum() / pos.sum().clamp(min=1.0)

    # ---- ROI heads ------------------------------------------------------
    if rand_boxes is None:
        rand_boxes = random_boxes(tc.seed, step,
                                  tc.roi_n - tc.roi_topk - gt_boxes.shape[0],
                                  s, image.device, image.dtype)
    rois = _training_proposals(anchors, logits_flat, deltas_flat, gt_boxes,
                               gt_valid, s, tc.roi_topk, rand_boxes)
    cls_t, fg, arg, roi_deltas_t = assign_roi_targets(
        rois, gt_boxes, gt_classes, gt_valid, mc.num_classes, tc.roi_fg_iou)
    fg_f = fg.to(logits_flat.dtype)
    scores, box_deltas = model.box_apply(feats, rois)
    cls_loss = _cross_entropy(scores, cls_t).mean()
    r = rois.shape[0]
    bd = box_deltas.reshape(r, mc.num_classes, 4)
    cls_idx = cls_t.clamp(0, mc.num_classes - 1)
    bd_sel = bd.gather(1, cls_idx[:, None, None].expand(r, 1, 4))[:, 0]
    reg_l1 = (bd_sel - roi_deltas_t).abs().sum(dim=1)
    reg_loss = (reg_l1 * fg_f).sum() / fg_f.sum().clamp(min=1.0)
    loss = rpn_obj + rpn_box + cls_loss + reg_loss
    aux = {"rpn_obj": rpn_obj, "rpn_box": rpn_box, "cls": cls_loss,
           "reg": reg_loss}

    if mc.with_masks:
        mask_logits = model.mask_apply(feats, rois)     # [R, 28, 28, K]
        side = mask_logits.shape[1]
        sel = mask_logits.gather(-1, cls_idx.reshape(r, 1, 1, 1).expand(
            r, side, side, 1))[..., 0]
        crops = roi_align(gt_masks.permute(1, 2, 0), rois, pooled=side)
        tgt = crops.gather(-1, arg.reshape(r, 1, 1, 1).expand(
            r, side, side, 1))[..., 0]
        tgt = (tgt > 0.5).to(sel.dtype)
        mbce = _sigmoid_bce(sel, tgt).mean(dim=(1, 2))
        mask_loss = (mbce * fg_f).sum() / fg_f.sum().clamp(min=1.0)
        loss = loss + tc.mask_weight * mask_loss
        aux["mask"] = mask_loss

    if mc.with_keypoints and gt_keypoints is not None:
        kr = min(tc.keypoint_rois, tc.roi_n)
        sel = torch.argsort(-fg_f, stable=True)[:kr]    # GT ROIs first
        kp_rois = rois[sel]
        heat = model.keypoint_apply(feats, kp_rois)     # [kr, S, S, K]
        side = heat.shape[1]
        kps = gt_keypoints[arg[sel]]                    # [kr, K, 3]
        x1, y1 = kp_rois[:, 0:1], kp_rois[:, 1:2]
        bw = (kp_rois[:, 2:3] - x1).clamp(min=1e-3)
        bh = (kp_rois[:, 3:4] - y1).clamp(min=1e-3)
        ix = torch.floor((kps[..., 0] - x1) / bw * side).long()
        iy = torch.floor((kps[..., 1] - y1) / bh * side).long()
        # a keypoint on the ROI's right or bottom edge goes into the last
        # bin (Detectron2's keypoints_to_heatmap)
        ix = torch.where(ix == side, side - 1, ix)
        iy = torch.where(iy == side, side - 1, iy)
        inside = (ix >= 0) & (ix < side) & (iy >= 0) & (iy < side)
        vis = (kps[..., 2] > 0) & inside & fg[sel][:, None]
        tgt = iy.clamp(0, side - 1) * side + ix.clamp(0, side - 1)
        k = heat.shape[-1]
        kl = heat.reshape(kr, side * side, k).transpose(1, 2)
        kce = _cross_entropy(kl.reshape(kr * k, side * side),
                             tgt.reshape(-1)).reshape(kr, k)
        visf = vis.to(kce.dtype)
        kp_loss = (kce * visf).sum() / visf.sum().clamp(min=1.0)
        loss = loss + tc.keypoint_weight * kp_loss
        aux["kp"] = kp_loss
    return loss, aux


def init_detection_train_state(model: GeneralizedRCNN,
                               cfg: DetectionTrainConfig) -> AdamWClip:
    """``optax.adamw(lr, weight_decay)`` over ``model``'s parameters."""
    return AdamWClip(dict(model.named_parameters()), lambda count: cfg.lr,
                     cfg.weight_decay)


def make_detection_train_step(model: GeneralizedRCNN, opt: AdamWClip,
                              cfg: DetectionTrainConfig) -> Callable:
    """``step(image, gt_boxes, gt_classes, gt_masks, gt_valid,
    gt_keypoints=None) -> (loss, aux)`` (detached tensors): the loss of
    optimiser step ``opt.count`` (its random proposals drawn for that
    count), its gradients and one update."""
    p0 = next(model.parameters())
    anchors = level_anchors(cfg.image_size, p0.device, p0.dtype)

    def step(image, gt_boxes, gt_classes, gt_masks, gt_valid,
             gt_keypoints=None):
        for p in opt.params.values():
            p.grad = None
        loss, aux = detection_loss(model, cfg, anchors, image, gt_boxes,
                                   gt_classes, gt_masks, gt_valid,
                                   gt_keypoints, step=opt.count)
        loss.backward()
        opt.step()
        return loss.detach(), {k: v.detach() for k, v in aux.items()}
    return step


def tiny_stopsign_config(image_size: int = 320) -> RCNNConfig:
    """The synthetic-trainable stop-sign detector: 1-block stages, the
    COCO class space (stop sign = 11), a plain mask head."""
    return RCNNConfig(blocks=(1, 1, 1, 1), num_classes=80,
                      with_masks=True, with_pointrend=False,
                      score_thresh=0.5, post_nms_topk=256,
                      max_detections=16, test_short_side=image_size,
                      test_max_side=image_size * 2)


def tiny_people_config(image_size: int = 320) -> RCNNConfig:
    """The synthetic-trainable person detector: as
    :func:`tiny_stopsign_config`, with the keypoint head."""
    return RCNNConfig(blocks=(1, 1, 1, 1), num_classes=80,
                      with_masks=True, with_pointrend=False,
                      with_keypoints=True,
                      score_thresh=0.5, post_nms_topk=256,
                      max_detections=16, test_short_side=image_size,
                      test_max_side=image_size * 2)


def to_device(sample, device) -> list:
    """A synthetic dataset's sample as tensors on ``device``."""
    return [torch.from_numpy(np.asarray(a)).to(device) for a in sample]


def train_detector(opt_name: str, steps: int, out_dir: str, device="cuda",
                   log_every: int = 50) -> str:
    """The JAX scripts' detector stage: the tiny config at 320 px from
    :func:`seeded_init` weights, one synthetic scene a step (dataset seed
    0, scene ``i`` at step ``i``), a log line every ``log_every`` steps;
    writes ``out_dir/best.npz`` (the final weights, in the JAX flat
    layout) and ``out_dir/rcnn_config.json``. Returns the npz path."""
    from ..core.checkpoint import save_flat_npz
    from ..core.convert import export_rcnn_variables
    from ..data import SyntheticPeopleDataset, SyntheticStopsignDataset

    device = resolve_device(device)
    tc = DetectionTrainConfig()
    people = opt_name == "people"
    mc = (tiny_people_config if people else tiny_stopsign_config)(
        tc.image_size)
    model = seeded_init(GeneralizedRCNN(mc, trainable_bn=True),
                        tc.seed).to(device)
    opt = init_detection_train_state(model, tc)
    step_fn = make_detection_train_step(model, opt, tc)
    ds = (SyntheticPeopleDataset if people else SyntheticStopsignDataset)(
        n=steps, size=tc.image_size, seed=tc.seed)
    t0 = time.time()
    losses = []
    for i in range(steps):
        loss, aux = step_fn(*to_device(ds.get(i), device))
        losses.append(float(loss))
        if i % log_every == 0 or i == steps - 1:
            a = {k: round(float(v), 4) for k, v in aux.items()}
            print(f"{opt_name} step {i}/{steps} loss {losses[-1]:.4f} {a} "
                  f"({time.time() - t0:.0f}s)", flush=True)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "best.npz")
    save_flat_npz(path, export_rcnn_variables(model.state_dict()))
    with open(os.path.join(out_dir, "rcnn_config.json"), "w") as f:
        json.dump(dataclasses.asdict(mc), f, indent=1)
    print(f"checkpoint saved: {out_dir} (final loss "
          f"{np.mean(losses[-50:]):.4f})", flush=True)
    return path


def main() -> None:
    p = argparse.ArgumentParser(
        description="flowtide (PyTorch/CUDA): synthetic-scene detector "
                    "trainer")
    p.add_argument("--opt", choices=("stopsign", "people"), required=True)
    p.add_argument("--steps", type=int, default=1500)
    p.add_argument("--out", type=str, required=True,
                   help="Directory for best.npz and rcnn_config.json")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' or 'cpu'.")
    args = p.parse_args()
    if torch.device(args.device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    train_detector(args.opt, args.steps, args.out, args.device)


if __name__ == "__main__":
    main()
