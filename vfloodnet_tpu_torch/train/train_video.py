"""AFB-URR trainer (counterpart of ``vfloodnet_tpu.train.train_video``).

The reference's objective (``train_video_seg.py``): per clip, build a bank
from frame 0 (``memorize``), segment the other frames against it, and
minimise cross-entropy + ``lambda_u`` x the uncertainty loss, with AdamW
(lr 1e-5) behind a global-norm clip, the rate halved every 25 epochs, and
frozen BatchNorm (or live, ``update_bn``, for training from scratch).

The model is the training form, ``AFBURR(trainable_bn=True)``
(:func:`init_afb_urr`, or the weight bridge's ``trainable_bn``). Its
segment reads the bank with the plain dense read with gradients on every
device; the CUDA read and count kernels are forward-only and serve
inference. The optimiser is written out to give optax's numbers
(:class:`AdamWClip`); the schedule counts optimiser steps as optax's does.

Run ``python -m vfloodnet_tpu_torch.train.train_video --dataset ROOT
[--device cpu]`` (the flags of the root ``train_video_seg.py`` but
``--data-parallel``).
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ..core import resolve_device
from ..models import AFBURR
from ..models.resnet import TrainBN

BN_MOMENTUM = 0.9


@dataclasses.dataclass
class VideoTrainConfig:
    lr: float = 1e-5
    weight_decay: float = 0.01
    lambda_u: float = 0.5          # --lu
    scheduler_step_epochs: int = 25
    scheduler_gamma: float = 0.5
    clip_n: int = 6
    max_obj_n: int = 3
    output_size: int = 400
    epochs: int = 100
    seed: int = 0
    # Recompute instead of keep: each clip's forward, in the backward pass.
    remat: bool = False
    # Live BatchNorm: batch statistics, and running statistics updated by
    # 0.9 * stat + 0.1 * batch. The reference freezes BN (ImageNet
    # statistics); training from scratch needs it live.
    update_bn: bool = False
    # Global-norm gradient clip (0 = off): the decoder's log-odds are
    # unbounded, and at a seeded init huge.
    grad_clip: float = 1.0


def batch_norms(model: nn.Module) -> List[TrainBN]:
    """The training form's BatchNorms, in module order."""
    return [m for m in model.modules() if isinstance(m, TrainBN)]


def _pass_stats(bns: List[TrainBN]) -> List[Optional[tuple]]:
    """Each BN's running (mean, var) after one pass that normalised with
    batch statistics, ``0.9 * stat + 0.1 * batch`` (the JAX ``FrozenBN``'s
    arithmetic), or None where the pass did not run it; clears the
    batch statistics for the next pass."""
    out = []
    for bn in bns:
        if bn.batch_mean is None:
            out.append(None)
            continue
        m = BN_MOMENTUM
        out.append((m * bn.mean + (1.0 - m) * bn.batch_mean,
                    m * bn.var + (1.0 - m) * bn.batch_var))
        bn.batch_mean = bn.batch_var = None
    return out


def _cross_entropy(score: torch.Tensor, labels: torch.Tensor
                   ) -> torch.Tensor:
    """``logsumexp - logit of the label`` over axis 1 (optax's
    ``softmax_cross_entropy_with_integer_labels``); unlike
    ``F.cross_entropy`` on the card, it adds nothing with atomics."""
    return torch.logsumexp(score, dim=1) - score.gather(
        1, labels[:, None]).squeeze(1)


def video_clip_loss(model: AFBURR, frames: torch.Tensor, masks: torch.Tensor,
                    lambda_u: float, remat: bool = False,
                    update_bn: bool = False):
    """The loss of a batch of clips, and the BatchNorms' new running
    statistics (None unless ``update_bn``).

    frames [B, T, H, W, 3] in [0, 1]; masks [B, T, obj_n, H, W] one-hot.
    Per clip: memorize frame 0, segment frames 1..T-1 against an all-valid
    bank of its keys, cross-entropy with the argmax of the masks plus
    ``lambda_u`` x the uncertainty loss; the mean over clips.

    With ``update_bn`` each clip normalises with its own statistics (the
    JAX loss vmaps over clips), and its new running statistics are the
    mean of the updates of its memorize pass and its segment pass, both
    from the incoming statistics (a BN that a pass does not run keeps
    them); the step's are the mean over clips. The BNs' ``live`` flag is
    set to ``update_bn`` here and left so for the backward pass, whose
    recomputation (``remat``) must normalise as the forward did.

    ``remat``: each clip runs under ``torch.utils.checkpoint``
    (non-reentrant), as the JAX loss checkpoints its per-clip function:
    the backward pass recomputes a clip's activations instead of keeping
    them, so a batch of B clips holds one clip's at a time."""
    bns = batch_norms(model)
    for bn in bns:
        bn.live = update_bn
        bn.batch_mean = bn.batch_var = None

    def per_clip(frames_c, masks_c):
        k4, v4 = model.memorize(frames_c[0], masks_c[0])
        stats_m = _pass_stats(bns) if update_bn else None
        valid = torch.ones(k4.shape[:2], dtype=torch.bool, device=k4.device)
        score, unc, _ = model.segment(frames_c[1:], k4, v4, valid,
                                      training=True)
        labels = masks_c[1:].argmax(dim=1)
        loss = _cross_entropy(score, labels).mean() + lambda_u * unc
        if not update_bn:
            return (loss,)
        stats = []
        for bn, a, b in zip(bns, stats_m, _pass_stats(bns)):
            old = (bn.mean, bn.var)
            a, b = a or old, b or old
            stats += [0.5 * (a[0] + b[0]), 0.5 * (a[1] + b[1])]
        return (loss, *stats)

    run = (lambda *a: checkpoint(per_clip, *a, use_reentrant=False)) \
        if remat else per_clip
    outs = [run(frames[c], masks[c]) for c in range(frames.shape[0])]
    loss = torch.stack([o[0] for o in outs]).mean()
    if not update_bn:
        return loss, None
    stats = [torch.stack([o[1 + i] for o in outs]).mean(dim=0).detach()
             for i in range(2 * len(bns))]
    return loss, stats


def make_lr_schedule(cfg: VideoTrainConfig, steps_per_epoch: int
                     ) -> Callable[[int], float]:
    """optax's ``piecewise_constant_schedule`` of the JAX trainer: the
    rate times ``scheduler_gamma`` once the optimiser's step count (from
    0) reaches each multiple of ``scheduler_step_epochs`` epochs, for
    ``max(epochs // scheduler_step_epochs, 1)`` drops."""
    n_drops = max(cfg.epochs // cfg.scheduler_step_epochs, 1)
    bounds = [i * cfg.scheduler_step_epochs * steps_per_epoch
              for i in range(1, n_drops + 1)]

    def schedule(count: int) -> float:
        return cfg.lr * cfg.scheduler_gamma ** sum(count >= b for b in bounds)
    return schedule


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay ** count`` in float32, as optax computes it."""
    one = np.float32(1.0)
    return float(one - np.float32(decay) ** np.float32(count))


class AdamWClip:
    """``optax.chain(clip_by_global_norm(grad_clip), adamw(schedule,
    weight_decay))`` over a model's parameters, with optax's arithmetic:
    the clip scales by ``grad_clip / norm`` where ``norm >= grad_clip``;
    then ``mu = 0.1 g + 0.9 mu``, ``nu = 0.001 g^2 + 0.999 nu``, the bias
    corrections with the incremented count, ``u = mu_hat / (sqrt(nu_hat)
    + 1e-8) + wd * p``, and ``p += -lr(count) * u`` with the count from
    before the step. No host sync: the clip is a ``torch.where``."""

    B1, B2, EPS = 0.9, 0.999, 1e-8      # optax.adamw's defaults

    def __init__(self, params: Dict[str, nn.Parameter],
                 schedule: Callable[[int], float], weight_decay: float,
                 grad_clip: float = 0.0):
        self.params = params
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip
        self.count = 0
        self.mu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in params.items()}

    @torch.no_grad()
    def step(self, grads: Optional[Dict[str, torch.Tensor]] = None) -> None:
        """One update from ``grads`` (default: each parameter's
        ``.grad``)."""
        names = list(self.params)
        p = [self.params[n] for n in names]
        g = [grads[n] for n in names] if grads is not None \
            else [q.grad for q in p]
        if self.grad_clip:
            norm = torch.stack(torch._foreach_norm(g)).square().sum().sqrt()
            keep = norm < self.grad_clip
            g = [torch.where(keep, x, x / norm * self.grad_clip) for x in g]
        b1, b2 = self.B1, self.B2
        mu = [self.mu[n] for n in names]
        nu = [self.nu[n] for n in names]
        new_mu = torch._foreach_add(torch._foreach_mul(g, 1 - b1),
                                    torch._foreach_mul(mu, b1))
        new_nu = torch._foreach_add(
            torch._foreach_mul(torch._foreach_mul(g, g), 1 - b2),
            torch._foreach_mul(nu, b2))
        count_inc = self.count + 1
        mu_hat = torch._foreach_div(new_mu, _bias_correction(b1, count_inc))
        nu_hat = torch._foreach_div(new_nu, _bias_correction(b2, count_inc))
        den = torch._foreach_add(torch._foreach_sqrt(nu_hat), self.EPS)
        u = torch._foreach_div(mu_hat, den)
        u = torch._foreach_add(u, torch._foreach_mul(p, self.weight_decay))
        u = torch._foreach_mul(u, -self.schedule(self.count))
        torch._foreach_add_(p, u)
        for n, m, v in zip(names, new_mu, new_nu):
            self.mu[n], self.nu[n] = m, v
        self.count = count_inc

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": self.mu, "nu": self.nu}

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        for n, p in self.params.items():
            self.mu[n] = state["mu"][n].to(p.device)
            self.nu[n] = state["nu"][n].to(p.device)


def init_video_train_state(model: AFBURR, cfg: VideoTrainConfig,
                           steps_per_epoch: int = 1000) -> AdamWClip:
    """The optimiser of ``model``'s parameters for ``cfg`` (the JAX
    ``init_video_train_state``; the step count is its ``count``)."""
    return AdamWClip(dict(model.named_parameters()),
                     make_lr_schedule(cfg, steps_per_epoch),
                     cfg.weight_decay, cfg.grad_clip)


def make_video_train_step(model: AFBURR, opt: AdamWClip,
                          cfg: VideoTrainConfig) -> Callable:
    """``step(frames, masks) -> loss`` (a detached 0-d tensor on the
    model's device): the loss and its gradients, one optimiser update, and
    with ``update_bn`` the running statistics written back. The BNs are
    left frozen afterwards."""
    bns = batch_norms(model)

    def step(frames: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
        for p in opt.params.values():
            p.grad = None
        loss, stats = video_clip_loss(model, frames, masks, cfg.lambda_u,
                                      remat=cfg.remat,
                                      update_bn=cfg.update_bn)
        loss.backward()
        opt.step()
        with torch.no_grad():
            for i, bn in enumerate(bns):
                bn.live = False
                if stats is not None:
                    bn.mean.copy_(stats[2 * i])
                    bn.var.copy_(stats[2 * i + 1])
        return loss.detach()
    return step


def _variance_scaling_(w: torch.Tensor, scale: float, mode: str,
                       gen: torch.Generator) -> None:
    """Flax's ``variance_scaling(scale, mode, "truncated_normal")`` on an
    OIHW kernel: a normal cut at two deviations, rescaled to variance
    ``scale / fan``."""
    o, i, kh, kw = w.shape
    fan = kh * kw * (i if mode == "fan_in" else o)
    std = math.sqrt(scale / fan) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=gen)


@torch.no_grad()
def init_afb_urr(seed: int = 0, device="cuda") -> AFBURR:
    """A training-form AFB-URR with the JAX model's initialisers, drawn
    from ``seed`` (torch's generator, not JAX's keys): the encoders' and
    the key-value head's kernels LeCun normal (the memory encoder's three
    stem planes each with its own fan-in), the decoder's He normal on the
    fan-out, biases zero, BatchNorm scale 1, bias 0, mean 0, var 1."""
    device = resolve_device(device)
    model = AFBURR(trainable_bn=True)
    gen = torch.Generator().manual_seed(seed)
    for name, mod in model.named_modules():
        if not isinstance(mod, nn.Conv2d):
            continue
        if name == "encoder_m.backbone.conv1":
            for lo, hi in ((0, 3), (3, 4), (4, 5)):
                _variance_scaling_(mod.weight[:, lo:hi], 1.0, "fan_in", gen)
        elif name.startswith("decoder."):
            _variance_scaling_(mod.weight, 2.0, "fan_out", gen)
        else:
            _variance_scaling_(mod.weight, 1.0, "fan_in", gen)
        if mod.bias is not None:
            mod.bias.zero_()
    return model.to(device)


def _args():
    p = argparse.ArgumentParser(
        description="flowtide (PyTorch/CUDA): AFB-URR video-seg trainer")
    p.add_argument("--dataset", type=str, required=True,
                   help="Dataset root (train_imgs.txt + JPEGImages/"
                        "Annotations)")
    p.add_argument("--log", type=str, default=None, help="Log dir")
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--lu", type=float, default=0.5,
                   help="Uncertainty loss weight")
    p.add_argument("--scheduler-step", type=int, default=25)
    p.add_argument("--total-epochs", type=int, default=100)
    p.add_argument("--clip-n", type=int, default=6)
    p.add_argument("--obj-n", type=int, default=3)
    p.add_argument("--output-size", type=int, default=400)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--resume", type=str, default=None,
                   help="A final.pt or best.pt of an earlier run")
    p.add_argument("--remat", action="store_true",
                   help="Recompute each clip's activations in the "
                        "backward pass (less memory at a batch of more "
                        "than one clip, more work)")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' or 'cpu'.")
    return p.parse_args()


def main() -> None:
    from ..data import WaterVideoTrainDataset
    from ..utils import gct
    from .loops import run_video_training

    args = _args()
    print(gct(), "Args =", args)
    if torch.device(args.device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True   # exact resume
    cfg = VideoTrainConfig(
        lr=args.lr, lambda_u=args.lu,
        scheduler_step_epochs=args.scheduler_step, epochs=args.total_epochs,
        clip_n=args.clip_n, max_obj_n=args.obj_n,
        output_size=args.output_size, seed=args.seed, remat=args.remat)
    log_dir = args.log or os.path.join(
        "logs", time.strftime("%Y%m%d-%H%M%S") + "_video_seg")
    dataset = WaterVideoTrainDataset(
        args.dataset, output_size=cfg.output_size, clip_n=cfg.clip_n,
        max_obj_n=cfg.max_obj_n, seed=cfg.seed)
    model = init_afb_urr(cfg.seed, args.device)
    best = run_video_training(model, cfg, dataset, log_dir,
                              batch_size=args.batch_size, resume=args.resume)
    print(gct(), f"Training done. Best checkpoint: {best}")


if __name__ == "__main__":
    main()
