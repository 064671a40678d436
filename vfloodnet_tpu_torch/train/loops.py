"""The video trainer's loop (counterpart of
``vfloodnet_tpu.train.loops.run_video_training``).

Epochs over a :class:`..data.BatchLoader`, a log line and a
``metrics.jsonl`` record every ``log_every`` steps and at each epoch's
end, a snapshot of the sources in the log directory, and checkpoints
where the JAX loop writes orbax ``final/`` and ``best/``: ``final.pt``
after every epoch and ``best.pt`` at the lowest epoch loss, each holding
the model's ``state_dict``, the optimiser's state, the step and the
epoch, plus ``best.npz``, the weights in the JAX package's flat layout,
which both packages' ``load_afb_urr`` read.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import torch

from ..core.checkpoint import save_flat_npz
from ..core.convert import export_afb_urr_variables
from ..data import BatchLoader
from ..utils import AvgMeter, MetricWriter, gct, save_scripts

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _save(path: str, model, opt, step: int,
                          epoch: int) -> None:
    """``{"model", "optimizer", "step", "epoch"}`` through a temporary file
    renamed into place."""
    tmp = path + ".tmp"
    torch.save({"model": model.state_dict(), "optimizer": opt.state_dict(),
                "step": step, "epoch": epoch}, tmp)
    os.replace(tmp, path)


def run_video_training(model, cfg, dataset, log_dir: str,
                       batch_size: int = 1, resume: Optional[str] = None,
                       log_every: int = 10) -> str:
    """Train the training-form ``model`` (on its device) for ``cfg.epochs``
    epochs of ``dataset``, batches made on this thread; ``resume``, a
    ``final.pt`` or ``best.pt``, restores model, optimiser and step and
    restarts at epoch ``step // steps_per_epoch``. Returns the path of
    ``best.npz``."""
    from .train_video import init_video_train_state, make_video_train_step

    os.makedirs(log_dir, exist_ok=True)
    save_scripts(log_dir, _REPO)
    device = next(model.parameters()).device
    loader = BatchLoader(dataset, batch_size, shuffle=True, seed=cfg.seed)
    steps_per_epoch = max(len(loader), 1)
    opt = init_video_train_state(model, cfg, steps_per_epoch)
    start_epoch = 0
    if resume and os.path.exists(resume):
        blob = torch.load(resume, map_location=device, weights_only=True)
        model.load_state_dict(blob["model"])
        opt.load_state_dict(blob["optimizer"])
        start_epoch = int(blob["step"]) // steps_per_epoch
        print(gct(), f"Resumed from {resume} at epoch {start_epoch}")
    step_fn = make_video_train_step(model, opt, cfg)

    best_loss = float("inf")
    best_npz = os.path.join(log_dir, "best.npz")
    with MetricWriter(log_dir) as metrics:
        for epoch in range(start_epoch, cfg.epochs):
            meter = AvgMeter()
            t0 = time.time()
            for bi, (frames, masks, _) in enumerate(loader.epoch(epoch)):
                loss = step_fn(torch.from_numpy(frames).to(device),
                               torch.from_numpy(masks).to(device))
                meter.update(float(loss))
                if bi % log_every == 0:
                    print(gct(), f"epoch {epoch} step {bi}/{steps_per_epoch}"
                          f" loss {meter.avg:.4f}")
                    metrics.write("train", step=opt.count, loss=meter.avg,
                                  epoch=epoch)
            dt = time.time() - t0
            print(gct(), f"epoch {epoch} done: loss {meter.avg:.4f} "
                  f"({dt:.1f}s)")
            metrics.write("epoch", step=opt.count, loss=meter.avg,
                          epoch=epoch, seconds=dt)
            _save(os.path.join(log_dir, "final.pt"), model, opt, opt.count,
                  epoch)
            if meter.avg < best_loss:
                best_loss = meter.avg
                _save(os.path.join(log_dir, "best.pt"), model, opt,
                      opt.count, epoch)
                save_flat_npz(best_npz,
                              export_afb_urr_variables(model.state_dict()))
    return best_npz
