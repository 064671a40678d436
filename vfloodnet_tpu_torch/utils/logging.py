"""Metric log of a training run (counterpart of
``vfloodnet_tpu.utils.logging``): one JSON object an event, appended to
``<log_dir>/metrics.jsonl``."""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class MetricWriter:
    """Appends ``{"t", "event", "step", <metrics>}`` lines; numbers are
    written as floats. Close it, or use it as a context manager."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._fh = open(self.path, "a", buffering=1)

    def write(self, event: str, step: Optional[int] = None,
              **metrics: Any) -> None:
        rec: Dict[str, Any] = {"t": round(time.time(), 3), "event": event}
        if step is not None:
            rec["step"] = int(step)
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        self._fh.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
