"""Frames-per-second meter and a timestamp for log lines (counterpart of
``vfloodnet_tpu.utils.meters``)."""

from __future__ import annotations

import time
from datetime import datetime
from typing import Optional


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
