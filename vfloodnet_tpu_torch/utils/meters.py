"""Averaging and frames-per-second meters, a timestamp for log lines, and
a snapshot of the sources for a training run's log directory (counterpart
of ``vfloodnet_tpu.utils.meters``)."""

from __future__ import annotations

import os
import shutil
import time
from datetime import datetime
from typing import Optional


class AvgMeter:
    """Running average of the values given to :meth:`update`."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.avg = 0.0
        self.sum = 0.0
        self.cnt = 0

    def update(self, val: float, n: int = 1):
        self.cnt += n
        self.sum += val * n
        self.avg = self.sum / self.cnt


class FrameSecondMeter:
    """Frames per second from construction to :meth:`end`."""

    def __init__(self):
        self.st = time.time()
        self.frame_n = 0
        self.fps: Optional[float] = None

    def add_frame_n(self, n: int):
        self.frame_n += n

    def end(self) -> float:
        self.et = time.time()
        self.fps = self.frame_n / max(self.et - self.st, 1e-9)
        return self.fps


def gct(fmt: str = "%Y-%m-%d %H:%M:%S") -> str:
    """The current local time as text."""
    return datetime.now().strftime(fmt)


def save_scripts(log_dir: str, src_root: str = ".") -> None:
    """Copy every ``.py`` under ``src_root`` (but version control, caches,
    outputs, logs, records and assets) into ``<log_dir>/scripts``, so a run
    keeps the code that made it."""
    dst = os.path.join(log_dir, "scripts")
    os.makedirs(dst, exist_ok=True)
    skip = {".git", "__pycache__", "output", "logs", "records", "assets",
            ".pytest_cache", "_build"}
    for dirpath, dirnames, filenames in os.walk(src_root):
        dirnames[:] = [d for d in dirnames if d not in skip]
        for fn in filenames:
            if fn.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, fn), src_root)
                target = os.path.join(dst, rel)
                os.makedirs(os.path.dirname(target), exist_ok=True)
                shutil.copyfile(os.path.join(dirpath, fn), target)
