"""LinkNet image-segmentation trainer (counterpart of
``vfloodnet_tpu.train.train_image``).

The reference's objective (``train_image_seg.py``): Dice loss, IoU at 0.5
as the metric, Adam at 1e-4 dropping to 1e-5 at half the epochs, frozen
BatchNorm (or live, ``update_bn``, for training from scratch). The model
is the training form, ``LinkNet(norm=TrainBN)`` (:func:`init_linknet`, or
the weight bridge's ``trainable_bn``); the optimiser is
:class:`.train_video.AdamWClip` without weight decay or clip, which is
``optax.adam``'s arithmetic.

Run ``python -m vfloodnet_tpu_torch.train.train_image --dataset ROOT
[--device cpu] [--data-parallel]`` (the flags of the root
``train_image_seg.py``; ``--data-parallel`` starts one rank per GPU,
:mod:`.data_parallel`).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Callable

import torch
import torch.nn as nn

from ..core import resolve_device
from ..models import LinkNet
from ..models.resnet import TrainBN
from ..parallel import MODEL_AXIS
from .data_parallel import average_grads, data_shard, mean_over_group
from .train_video import AdamWClip, _pass_stats, _variance_scaling_, \
    batch_norms


@dataclasses.dataclass
class ImageTrainConfig:
    lr: float = 1e-4
    lr_late: float = 1e-5          # the rate from half the epochs on
    epochs: int = 40
    batch_size: int = 8
    input_size: int = 416
    seed: int = 0
    # Live BatchNorm: batch statistics, and running statistics updated by
    # 0.9 * stat + 0.1 * batch. The reference trains from ImageNet
    # statistics; from scratch, frozen identity statistics make the model
    # an input-independent positional prior.
    update_bn: bool = False


def dice_loss(pred: torch.Tensor, target: torch.Tensor,
              eps: float = 1.0) -> torch.Tensor:
    """Soft Dice loss on probabilities [B, ...] (smp's ``DiceLoss``)."""
    p = pred.reshape(pred.shape[0], -1)
    t = target.reshape(target.shape[0], -1)
    inter = (p * t).sum(dim=1)
    denom = p.sum(dim=1) + t.sum(dim=1)
    return 1.0 - ((2.0 * inter + eps) / (denom + eps)).mean()


def iou_metric(pred: torch.Tensor, target: torch.Tensor,
               thres: float = 0.5, eps: float = 1e-7) -> torch.Tensor:
    """IoU of ``pred > thres`` and ``target > 0.5``, the batch's mean
    (smp's ``IoU``)."""
    p = (pred > thres).to(pred.dtype).reshape(pred.shape[0], -1)
    t = (target > 0.5).to(pred.dtype).reshape(target.shape[0], -1)
    inter = (p * t).sum(dim=1)
    union = p.sum(dim=1) + t.sum(dim=1) - inter
    return ((inter + eps) / (union + eps)).mean()


def make_image_lr_schedule(cfg: ImageTrainConfig, steps_per_epoch: int
                           ) -> Callable[[int], float]:
    """optax's ``piecewise_constant_schedule(lr, {epochs // 2 *
    steps_per_epoch: lr_late / lr})``: ``lr`` until the optimiser's step
    count (from 0) reaches the boundary, then ``lr_late / lr * lr``."""
    bound = cfg.epochs // 2 * steps_per_epoch

    def schedule(count: int) -> float:
        return cfg.lr_late / cfg.lr * cfg.lr if count >= bound else cfg.lr
    return schedule


def init_image_train_state(model: LinkNet, cfg: ImageTrainConfig,
                           steps_per_epoch: int = 1000) -> AdamWClip:
    """The optimiser of ``model``'s parameters for ``cfg`` (the JAX
    ``init_image_train_state``'s ``optax.adam(schedule)``; the step count
    is its ``count``)."""
    return AdamWClip(dict(model.named_parameters()),
                     make_image_lr_schedule(cfg, steps_per_epoch),
                     weight_decay=0.0)


def make_image_train_step(model: LinkNet, opt: AdamWClip,
                          update_bn: bool = False, mesh=None) -> Callable:
    """``step(images [B, H, W, 3] in [0, 1], masks [B, H, W] in {0, 1})
    -> (dice loss, IoU)``, both detached 0-d tensors of the forward before
    the update: the loss's gradients, one optimiser update and, with
    ``update_bn``, the BNs normalising with the whole batch's statistics
    and their running statistics set to ``0.9 * stat + 0.1 * batch``. The
    BNs are left frozen afterwards.

    With a ``mesh`` (:mod:`.data_parallel`) every rank of its data axis
    calls the step with the same global batch and computes its contiguous
    share of the images; live statistics are the global batch's (the BNs
    all-reduce their sums over the data group), and the gradients, the
    loss and the IoU are averaged over it, so every rank takes the global
    batch's step. The ranks of a ``model`` axis compute the same images,
    replicated, as the JAX image step does (it shards no parameter)."""
    bns = batch_norms(model)
    group = None if mesh is None else mesh.data_group
    # gradients and loss are averaged over the data group, and over a
    # model axis larger than one over the model group too, as are the
    # running statistics: its ranks compute the same images, and their
    # results may differ in the last bits (cuDNN's backward is not
    # deterministic), so the averages keep their weights equal
    groups = [] if mesh is None else [group] + (
        [mesh.model_group] if mesh.size(MODEL_AXIS) > 1 else [])

    def step(images: torch.Tensor, masks: torch.Tensor):
        if mesh is not None:
            images, masks = data_shard(images, mesh), data_shard(masks, mesh)
        for p in opt.params.values():
            p.grad = None
        for bn in bns:
            bn.live, bn.group = update_bn, group
            bn.batch_mean = bn.batch_var = None
        prob = model(images)[..., 0]
        loss = dice_loss(prob, masks)
        iou = iou_metric(prob.detach(), masks)
        stats = _pass_stats(bns) if update_bn else None
        loss.backward()
        for over in groups:
            average_grads(opt.params.values(), over)
            loss, iou = mean_over_group([loss, iou], over)
        opt.step()
        with torch.no_grad():
            for i, bn in enumerate(bns):
                bn.live = False
                if stats is not None:
                    bn.mean.copy_(stats[i][0])
                    bn.var.copy_(stats[i][1])
            if stats is not None and len(groups) > 1:
                buffers = [t for bn in bns for t in (bn.mean, bn.var)]
                for t, m in zip(buffers, mean_over_group(buffers,
                                                         groups[1])):
                    t.copy_(m)
        return loss.detach(), iou
    return step


@torch.no_grad()
def init_linknet(seed: int = 0, device="cuda") -> LinkNet:
    """A training-form LinkNet with the JAX model's initialisers, drawn
    from ``seed`` (torch's generator, not JAX's keys): every kernel LeCun
    normal (a depthwise kernel on its one input plane), biases zero,
    BatchNorm scale 1, bias 0, mean 0, var 1."""
    device = resolve_device(device)
    model = LinkNet(norm=TrainBN)
    gen = torch.Generator().manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, nn.Conv2d):
            _variance_scaling_(mod.weight, 1.0, "fan_in", gen)
            if mod.bias is not None:
                mod.bias.zero_()
    return model.to(device)


def _args():
    p = argparse.ArgumentParser(
        description="flowtide (PyTorch/CUDA): LinkNet image-seg trainer")
    p.add_argument("--dataset", type=str, required=True,
                   help="Dataset root (train_imgs.txt, optionally "
                        "val_imgs.txt, + JPEGImages/Annotations)")
    p.add_argument("--encoder", type=str, default="efficientnet-b4",
                   help="Encoder name (efficientnet-b4 supported)")
    p.add_argument("--epochs", type=int, default=40)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--input-size", type=int, default=416)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log", type=str, default=None, help="Log dir")
    p.add_argument("--resume", type=str, default=None,
                   help="A final.pt or best.pt of an earlier run")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' or 'cpu'.")
    p.add_argument("--data-parallel", action="store_true",
                   help="Split each batch over one rank per visible GPU "
                        "(NCCL; with --device cpu, two gloo processes)")
    return p.parse_args()


def _train(mesh, device, args) -> str:
    """One rank's run of the CLI (``mesh`` None: the only one)."""
    from ..data import WaterImageDataset
    from .loops import run_image_training

    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True   # exact resume
    cfg = ImageTrainConfig(lr=args.lr, epochs=args.epochs,
                           batch_size=args.batch_size,
                           input_size=args.input_size, seed=args.seed)
    dataset = WaterImageDataset("train_offline", args.dataset,
                                input_size=cfg.input_size, seed=cfg.seed)
    val_dataset = None
    if os.path.exists(os.path.join(args.dataset, "val_imgs.txt")):
        val_dataset = WaterImageDataset("train_offline", args.dataset,
                                        input_size=cfg.input_size,
                                        dataset_file="val_imgs.txt",
                                        seed=cfg.seed)
    model = init_linknet(cfg.seed, device)
    return run_image_training(model, cfg, dataset, args.log,
                              val_dataset=val_dataset, resume=args.resume,
                              mesh=mesh)


def main() -> None:
    from ..utils import gct
    from .data_parallel import spawn_ranks

    args = _args()
    print(gct(), "Args =", args)
    if args.encoder != "efficientnet-b4":
        raise NotImplementedError(f"encoder {args.encoder}")
    args.log = args.log or os.path.join(
        "logs", time.strftime("%Y%m%d-%H%M%S") + "_image_seg")
    if args.data_parallel:
        spawn_ranks(_train, (args,), args.device, args.log)
        best = os.path.join(args.log, "best.npz")
    else:
        best = _train(None, resolve_device(args.device), args)
    print(gct(), f"Training done. Best checkpoint: {best}")


if __name__ == "__main__":
    main()
