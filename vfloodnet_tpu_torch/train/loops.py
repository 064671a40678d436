"""The video and image trainers' loops (counterpart of
``vfloodnet_tpu.train.loops``).

Epochs over a :class:`..data.BatchLoader`, log lines and
``metrics.jsonl`` records, and checkpoints where the JAX loops write
orbax ``final/`` and ``best/``: ``final.pt`` after every epoch and
``best.pt`` at the best epoch, each holding the model's ``state_dict``,
the optimiser's state, the step and the epoch, plus ``best.npz``, the
weights in the JAX package's flat layout, which both packages' loaders
read (``load_afb_urr``, ``load_linknet``). The video loop also snapshots
the sources into the log directory; the image loop plots its curves.

With a ``mesh`` (:mod:`.data_parallel`) every rank of the world runs the
loop over the same global batches and takes the data-parallel step and
its share of each validation batch; only rank 0 prints, logs and writes
checkpoints.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch

from ..core.checkpoint import save_flat_npz
from ..core.convert import (export_afb_urr_variables,
                            export_linknet_variables)
from ..data import BatchLoader
from ..utils import AvgMeter, MetricWriter, gct, save_scripts
from .data_parallel import (broadcast_model, data_shard, is_writer,
                            mean_over_data)

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _save(path: str, model, opt, step: int, epoch: int) -> None:
    """``{"model", "optimizer", "step", "epoch"}`` through a temporary file
    renamed into place."""
    tmp = path + ".tmp"
    torch.save({"model": model.state_dict(), "optimizer": opt.state_dict(),
                "step": step, "epoch": epoch}, tmp)
    os.replace(tmp, path)


class _NoMetrics:
    """The metric log of a rank that does not write."""

    def write(self, *args, **kwargs) -> None:
        pass


def _metrics(log_dir: str, writer: bool):
    return MetricWriter(log_dir) if writer else \
        contextlib.nullcontext(_NoMetrics())


def _resume(path: Optional[str], model, opt, steps_per_epoch: int) -> int:
    """Restore model and optimiser from a ``final.pt``/``best.pt`` at
    ``path``, if there is one; the epoch to start at."""
    if not (path and os.path.exists(path)):
        return 0
    device = next(model.parameters()).device
    blob = torch.load(path, map_location=device, weights_only=True)
    model.load_state_dict(blob["model"])
    opt.load_state_dict(blob["optimizer"])
    start = int(blob["step"]) // steps_per_epoch
    print(gct(), f"Resumed from {path} at epoch {start}")
    return start


def run_video_training(model, cfg, dataset, log_dir: str,
                       batch_size: int = 1, resume: Optional[str] = None,
                       log_every: int = 10, mesh=None) -> str:
    """Train the training-form ``model`` (on its device) for ``cfg.epochs``
    epochs of ``dataset``, batches made on this thread; ``resume``, a
    ``final.pt`` or ``best.pt``, restores model, optimiser and step and
    restarts at epoch ``step // steps_per_epoch``. With a ``mesh`` each
    batch of ``batch_size`` clips is split over its data axis. Returns the
    path of ``best.npz``."""
    from .train_video import init_video_train_state, make_video_train_step

    writer = is_writer(mesh)
    os.makedirs(log_dir, exist_ok=True)
    if writer:
        save_scripts(log_dir, _REPO)
    device = next(model.parameters()).device
    loader = BatchLoader(dataset, batch_size, shuffle=True, seed=cfg.seed)
    steps_per_epoch = max(len(loader), 1)
    opt = init_video_train_state(model, cfg, steps_per_epoch)
    start_epoch = _resume(resume, model, opt, steps_per_epoch)
    if mesh is not None:
        broadcast_model(model, mesh)
    step_fn = make_video_train_step(model, opt, cfg, mesh=mesh)
    say = print if writer else (lambda *a: None)

    best_loss = float("inf")
    best_npz = os.path.join(log_dir, "best.npz")
    with _metrics(log_dir, writer) as metrics:
        for epoch in range(start_epoch, cfg.epochs):
            meter = AvgMeter()
            t0 = time.time()
            for bi, (frames, masks, _) in enumerate(loader.epoch(epoch)):
                loss = step_fn(torch.from_numpy(frames).to(device),
                               torch.from_numpy(masks).to(device))
                meter.update(float(loss))
                if bi % log_every == 0:
                    say(gct(), f"epoch {epoch} step {bi}/{steps_per_epoch}"
                        f" loss {meter.avg:.4f}")
                    metrics.write("train", step=opt.count, loss=meter.avg,
                                  epoch=epoch)
            dt = time.time() - t0
            say(gct(), f"epoch {epoch} done: loss {meter.avg:.4f} "
                f"({dt:.1f}s)")
            metrics.write("epoch", step=opt.count, loss=meter.avg,
                          epoch=epoch, seconds=dt)
            if not writer:
                continue
            _save(os.path.join(log_dir, "final.pt"), model, opt, opt.count,
                  epoch)
            if meter.avg < best_loss:
                best_loss = meter.avg
                _save(os.path.join(log_dir, "best.pt"), model, opt,
                      opt.count, epoch)
                save_flat_npz(best_npz,
                              export_afb_urr_variables(model.state_dict()))
    return best_npz


def run_image_training(model, cfg, dataset, log_dir: str,
                       val_dataset=None, resume: Optional[str] = None,
                       log_every: int = 10, mesh=None) -> str:
    """Train the training-form LinkNet ``model`` (on its device) for
    ``cfg.epochs`` epochs of ``dataset``. With ``val_dataset``, a
    validation epoch (stored BN statistics, full batches only, as the
    JAX loop skips a short last one) follows each training epoch and
    ``best`` follows the validation IoU, else the training IoU;
    ``resume`` and ``mesh`` as in :func:`run_video_training` (each
    validation batch is split over the data axis too). Writes
    ``curves.png`` where matplotlib is installed. Returns the path of
    ``best.npz``."""
    from .train_image import init_image_train_state, make_image_train_step

    os.makedirs(log_dir, exist_ok=True)
    device = next(model.parameters()).device
    loader = BatchLoader(dataset, cfg.batch_size, shuffle=True,
                         seed=cfg.seed)
    steps_per_epoch = max(len(loader), 1)
    opt = init_image_train_state(model, cfg, steps_per_epoch)
    start_epoch = _resume(resume, model, opt, steps_per_epoch)
    if mesh is not None:
        broadcast_model(model, mesh)
    step_fn = make_image_train_step(model, opt, cfg.update_bn, mesh=mesh)
    writer = is_writer(mesh)
    say = print if writer else (lambda *a: None)
    val_loader = None if val_dataset is None else BatchLoader(
        val_dataset, cfg.batch_size, shuffle=False, seed=cfg.seed,
        drop_last=False)

    def upload(a):
        return torch.from_numpy(a).to(device)

    history = []
    best_iou = -1.0
    best_npz = os.path.join(log_dir, "best.npz")
    with _metrics(log_dir, writer) as metrics:
        for epoch in range(start_epoch, cfg.epochs):
            loss_m, iou_m = AvgMeter(), AvgMeter()
            for bi, (images, masks) in enumerate(loader.epoch(epoch)):
                loss, iou = step_fn(upload(images), upload(masks))
                loss_m.update(float(loss))
                iou_m.update(float(iou))
                if bi % log_every == 0:
                    say(gct(), f"epoch {epoch} step {bi}/"
                        f"{steps_per_epoch} dice {loss_m.avg:.4f} "
                        f"iou {iou_m.avg:.4f}")
            select_iou = iou_m.avg
            if val_loader is not None:
                select_iou = _val_iou(model, val_loader, cfg.batch_size,
                                      upload, mesh)
                say(gct(), f"epoch {epoch}: val iou {select_iou:.4f}")
            history.append((loss_m.avg, iou_m.avg))
            say(gct(), f"epoch {epoch}: dice {loss_m.avg:.4f} "
                f"iou {iou_m.avg:.4f}")
            metrics.write("epoch", step=opt.count, epoch=epoch,
                          dice=loss_m.avg, iou=iou_m.avg,
                          select_iou=select_iou)
            if not writer:
                continue
            _save(os.path.join(log_dir, "final.pt"), model, opt, opt.count,
                  epoch)
            if select_iou > best_iou:
                best_iou = select_iou
                _save(os.path.join(log_dir, "best.pt"), model, opt,
                      opt.count, epoch)
                save_flat_npz(best_npz,
                              export_linknet_variables(model.state_dict()))
    if writer:
        _plot_curves(history, log_dir)
    return best_npz


@torch.no_grad()
def _val_iou(model, loader, batch_size: int, upload, mesh) -> float:
    """The mean of the batches' IoUs over the full batches of ``loader``,
    under the stored BN statistics. With a ``mesh`` every rank computes
    its share of each batch, as the step splits it, and the shares' IoUs
    are averaged over the data group, in one all-reduce."""
    from .train_image import iou_metric

    ious = []
    for images, masks in loader.epoch(0):
        if images.shape[0] != batch_size:
            continue
        images, masks = upload(images), upload(masks)
        if mesh is not None:
            images, masks = data_shard(images, mesh), data_shard(masks, mesh)
        ious.append(iou_metric(model(images)[..., 0], masks))
    if mesh is not None and ious:
        ious = mean_over_data([torch.stack(ious)], mesh)[0]
    meter = AvgMeter()
    for iou in ious:
        meter.update(float(iou))
    return meter.avg


def _plot_curves(history, log_dir: str) -> None:
    """Dice and IoU per epoch into ``curves.png``. matplotlib is imported
    here; a plotting failure (no matplotlib, as on the card's machine) is
    printed and the run goes on, as in the JAX loop."""
    if not history:
        return
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        losses, ious = zip(*history)
        fig, ax = plt.subplots(1, 2, figsize=(10, 4))
        ax[0].plot(losses)
        ax[0].set_title("dice loss")
        ax[1].plot(ious)
        ax[1].set_title("IoU@0.5")
        fig.savefig(os.path.join(log_dir, "curves.png"), dpi=120)
        plt.close(fig)
    except Exception as e:   # plotting must never kill a training run
        print(gct(), f"curve plotting failed: {e}")
