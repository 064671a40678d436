"""Streaming water level: segmentation and the waterline scan in one
device-resident flow per frame (counterpart of
``vfloodnet_tpu.pipelines.streaming_waterlevel``).

Each frame runs the engine's step (one CUDA-graph replay on the card,
which also gives the operating-size label) and, right behind it on the
same stream, one scan of every reference box's column below its bottom
(:func:`..ops.waterline.waterline_below_batch`). The box columns and rows
live in a device buffer, written by a non-blocking copy only when the
boxes move; the [T] hits go to pinned host memory by a non-blocking copy
behind a CUDA event. So with the tracker off a frame makes no host sync:
the host waits only on an old frame's event when it resolves its levels
(:class:`BoundedResolver`). The tracker, where the site enables it, runs
outside the graph on the rectified frame and reads its PSR to the host
once a frame. Frames with a stored homography are rectified on the device
(:func:`..ops.homography.perspective_map`, made once per frame size). The runner starts no thread
pool: frames are decoded in turn.
"""

from __future__ import annotations

import os
from collections import deque
from datetime import datetime
from glob import glob
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.config import WATER_LABEL_ID, site_profile
from ..core.device import resolve_device
from ..memory import FeatureBank
from ..ops.homography import perspective_map
from ..ops.waterline import waterline_below_batch
from ..utils import FrameSecondMeter, gct, load_image, load_mask
from .video_seg import PendingLabel, VideoSegEngine


class PendingLevels(NamedTuple):
    """One frame's hits on their way to the host (a :class:`PendingLabel`:
    pinned memory behind a CUDA event on the card), with what turns them
    into levels: the start rows (operating-size pixels), the scale and
    the operating height."""
    hits: PendingLabel
    rows: List[int]
    scale: float
    small_h: int


class StreamingWaterLevel:
    """Per-frame fused segmentation and waterline. Reference boxes
    (x, y, w, h) are in full-resolution pixels and may be replaced between
    frames (``ref_bboxes[t] = ...``); the scan runs on the operating-size
    label on the device and the levels scale back."""

    def __init__(self, engine: VideoSegEngine,
                 ref_bboxes: Sequence[Tuple[int, int, int, int]]):
        self.engine = engine
        self.ref_bboxes = list(ref_bboxes)
        self._coords: Optional[torch.Tensor] = None   # int32 [2, T]
        self._coords_of = None     # the host (cols, rows) it holds

    def _scan_coords(self, scale: float) -> List[int]:
        """Bring the device buffer of box columns and start rows (at the
        operating size) up to date with ``ref_bboxes``; returns the
        rows."""
        cols = [int((x + w / 2) * scale) for x, y, w, h in self.ref_bboxes]
        rows = [int((y + h) * scale) for x, y, w, h in self.ref_bboxes]
        if (cols, rows) != self._coords_of:
            host = torch.tensor([cols, rows], dtype=torch.int32)
            if self.engine.device.type == "cuda":
                if self._coords is None or \
                        self._coords.shape != host.shape:
                    self._coords = torch.empty(host.shape, dtype=torch.int32,
                                               device=self.engine.device)
                self._coords.copy_(host.pin_memory(), non_blocking=True)
            else:
                self._coords = host
            self._coords_of = (cols, rows)
        return rows

    def step_async(self, state, frame, frame_idx: int):
        """One frame without waiting for its levels: (state, pending,
        label_small). :meth:`resolve` turns ``pending`` into levels."""
        full_h = frame.shape[0]
        state, _, label_small = self.engine.step_with_small(state, frame,
                                                            frame_idx)
        sh = label_small.shape[0]
        scale = sh / full_h
        rows = self._scan_coords(scale)
        hits = waterline_below_batch(label_small, self._coords[0],
                                     self._coords[1],
                                     water_label=WATER_LABEL_ID)
        pending = PendingLevels(PendingLabel(hits, None, False), rows,
                                scale, sh)
        return state, pending, label_small

    @staticmethod
    def resolve(pending: PendingLevels) -> List[float]:
        """Pending scan -> levels_px [T] in full-resolution pixels (NaN:
        no water below the box, or the water touches it)."""
        levels = []
        for hit, row in zip(pending.hits.result(), pending.rows):
            if hit >= pending.small_h:
                levels.append(np.nan)
            else:
                lv = (hit - row) / pending.scale
                levels.append(np.nan if lv <= 1.0 / pending.scale
                              else float(lv))
        return levels

    def step(self, state, frame, frame_idx: int):
        """Synchronous variant: (state, levels_px [T], label_small)."""
        state, pending, label_small = self.step_async(state, frame,
                                                      frame_idx)
        return state, self.resolve(pending), label_small


# Most unresolved frames the streaming runner holds: enough that a frame's
# hits have long reached the host when it is resolved, few enough that a
# video of days holds a bounded number of pinned buffers.
RESOLVE_LAG = 64


class BoundedResolver:
    """FIFO of pending levels holding at most ``lag`` frames: pushing one
    more resolves the oldest. Forward-fills NaN levels with the tracker's
    previous level (reference_tracking.py:197-204 keeps the previous level
    when no waterline is found)."""

    def __init__(self, stream: "StreamingWaterLevel", tracker_num: int,
                 lag: int = RESOLVE_LAG):
        self.stream = stream
        self.lag = max(1, lag)
        self.prev = [0.0] * tracker_num
        self.pending: deque = deque()
        self.levels: List[List[float]] = []
        self.max_live = 0

    def push(self, pending) -> None:
        self.pending.append(pending)
        while len(self.pending) > self.lag:
            self._drain_one()
        self.max_live = max(self.max_live, len(self.pending))

    def _drain_one(self) -> None:
        lv = self.stream.resolve(self.pending.popleft())
        lv = [p if np.isnan(v) else v for v, p in zip(lv, self.prev)]
        self.prev = lv
        self.levels.append(lv)

    def finish(self) -> List[List[float]]:
        while self.pending:
            self._drain_one()
        return self.levels


def _update_boxes(trackers, stream: StreamingWaterLevel, frame) -> None:
    """Track every box on ``frame`` (a device tensor, RGB) and keep each
    box whose tracker succeeded. The MOSSE tracker reads the tensor on its
    device; another tracker (OpenCV's) gets a host BGR copy."""
    from ..ops.tracker import MosseTracker
    bgr = None
    for t, tr in enumerate(trackers):
        if isinstance(tr, MosseTracker):
            ok, box = tr.update(frame)
        else:
            if bgr is None:
                bgr = np.ascontiguousarray(frame.cpu().numpy()[..., ::-1])
            ok, box = tr.update(bgr)
        if ok:
            stream.ref_bboxes[t] = tuple(int(v) for v in box)


def run_streaming_waterlevel(test_path: str, test_name: str,
                             out_dir: str, record_dir: str,
                             model=None, budget: int = 250_000,
                             downsample: int = 480,
                             image_model_path: Optional[str] = None,
                             device="cuda") -> str:
    """Water level of a long video without mask files between the stages:
    the ``waterlevel.csv`` of :func:`.reference_tracking.est_by_reference`
    from the frames alone. Needs a stored ``ref_bbox.txt``; a missing
    first-frame mask (``<out_dir>/segs/<test_name>/mask/<first>.png``) is
    made by the image model. ``model``: an AFB-URR (default: the bundled
    checkpoint on ``device``); the bank takes its compute dtype."""
    from .reference_tracking import (_make_trackers, _timestamp,
                                     write_levels_csv)

    device = resolve_device(device)
    prof = site_profile(test_name)
    img_list = sorted(glob(os.path.join(test_path, "*.jpg"))
                      + glob(os.path.join(test_path, "*.png")))
    if not img_list:
        raise FileNotFoundError(test_path)
    os.makedirs(out_dir, exist_ok=True)

    homo_mat = None
    if prof.enable_calib:
        homo_path = os.path.join(record_dir, test_name, "homo_mat.txt")
        if os.path.exists(homo_path):
            homo_mat = np.loadtxt(homo_path).reshape(3, 3)

    warps = {}       # frame size -> the homography's bilinear map

    def rectified(frame: torch.Tensor) -> torch.Tensor:
        if homo_mat is None:
            return frame
        hw = tuple(frame.shape[:2])
        if hw not in warps:
            warps[hw] = perspective_map(homo_mat, hw, device=frame.device)
        return warps[hw](frame)

    first_frame = rectified(torch.from_numpy(
        load_image(img_list[0]).copy()).to(device)).cpu().numpy()
    arr = np.loadtxt(os.path.join(record_dir, test_name,
                                  "ref_bbox.txt")).astype(int)
    ref_bboxes = [tuple(b) for b in np.atleast_2d(arr)[:prof.tracker_num]]
    trackers = None
    if prof.enable_tracker:
        trackers = _make_trackers(
            np.ascontiguousarray(first_frame[..., ::-1]), ref_bboxes, device)

    seg_dir = os.path.join(out_dir, "segs", test_name, "mask")
    first_name = os.path.splitext(os.path.basename(img_list[0]))[0]
    first_mask_path = os.path.join(seg_dir, first_name + ".png")
    if not os.path.exists(first_mask_path):
        from .image_seg import run_image_segmentation
        run_image_segmentation(img_list[0], test_name,
                               os.path.join(out_dir, "segs"),
                               model_path=image_model_path, device=device)
    first_mask = load_mask(first_mask_path)

    if model is None:
        from .loaders import load_afb_urr
        model = load_afb_urr(device=device)
    fb = FeatureBank(obj_n=int(first_mask.max()) + 1, memory_budget=budget,
                     dtype=model.dtype, device=device)
    engine = VideoSegEngine(model, fb, downsample=downsample,
                            postprocess="none")
    state = engine.bootstrap(first_frame, first_mask)
    stream = StreamingWaterLevel(engine, ref_bboxes)

    timestamps: List[datetime] = []
    resolver = BoundedResolver(stream, prof.tracker_num)
    fps = FrameSecondMeter()
    for idx, path in enumerate(img_list[1:]):
        frame = load_image(path)
        if homo_mat is not None or trackers is not None:
            frame = rectified(engine.upload(frame))
        if trackers is not None:
            _update_boxes(trackers, stream, frame)
        state, pending, _ = stream.step_async(state, frame, idx + 1)
        resolver.push(pending)
        fps.add_frame_n(1)
        timestamps.append(_timestamp(path, prof.time_fmt, idx))
    levels = resolver.finish()
    fps.end()

    csv_path, _ = write_levels_csv(levels, timestamps, prof.tracker_num,
                                   out_dir)
    print(gct(), f"streaming waterlevel: {fps.fps:.2f} frames/s "
          f"(device-resident masks)")
    return csv_path
