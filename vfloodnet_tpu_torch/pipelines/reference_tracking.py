"""Long-video water level against a fixed reference object, from the
segmentation stage's mask files (counterpart of
``vfloodnet_tpu.pipelines.reference_tracking``).

Per frame: optional homography rectification of the frame and its mask
(:mod:`..ops.homography`, on the device), the reference boxes (stored
``ref_bbox.txt``, or picked in an OpenCV window), optional tracking of
them (OpenCV CSRT where the build has it, else the port's MOSSE tracker,
else static boxes), and the waterline below each box's bottom centre: one
device scan of every box (:func:`..ops.waterline.waterline_below_batch`)
and one host read a frame, where the JAX package scans and reads once per
box. Levels are smoothed over time (Gaussian, sigma 2 frames) and written
as ``waterlevel.csv`` beside a hydrograph plot and, with ``viz``, overlays.
PIL, OpenCV, pandas and matplotlib are imported only inside the functions
that read, write or draw.
"""

from __future__ import annotations

import csv
import os
import shutil
import warnings
from datetime import datetime
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.config import WATER_LABEL_ID, site_profile
from ..core.device import resolve_device
from ..ops.homography import perspective_map, warp_perspective_mask
from ..ops.waterline import waterline_below_batch
from ..utils import COLOR_PALETTE, add_overlay, load_image, load_mask

LINE_COLOR = (0, 0, 200)     # BGR: waterline marks
BOX_COLOR = (0, 200, 0)      # BGR: reference boxes


def load_or_pick_homography(first_img_path: str, homo_mat_path: str
                            ) -> Optional[np.ndarray]:
    """Load a stored 3x3 homography; interactively pick 4 points if absent
    (reference get_video_homo, :44-81)."""
    if os.path.exists(homo_mat_path):
        return np.loadtxt(homo_mat_path).reshape(3, 3)
    try:
        return _interactive_homography(first_img_path, homo_mat_path)
    except Exception as e:
        raise RuntimeError(
            f"No homography at {homo_mat_path} and interactive calibration "
            f"unavailable ({e}). Provide homo_mat.txt.") from e


def _interactive_homography(img_path: str, out_path: str) -> np.ndarray:
    import cv2
    pts: List[Tuple[int, int]] = []
    win = "Select 4 pts (TopLeft, TopRight, BottomLeft, BottomRight)"
    img = cv2.imread(img_path)

    def on_mouse(event, x, y, flags, param):
        if event == cv2.EVENT_LBUTTONDOWN:
            pts.append((x, y))
            cv2.circle(param, (x, y), 5, (0, 0, 200), -1)
            cv2.imshow(win, param)

    canvas = img.copy()
    cv2.namedWindow(win)
    cv2.setMouseCallback(win, on_mouse, param=canvas)
    cv2.imshow(win, img)
    while len(pts) < 4:
        cv2.waitKey(30)
    cv2.destroyWindow(win)

    d_x = float(np.hypot(pts[1][0] - pts[0][0], pts[1][1] - pts[0][1]))
    d_y = float(np.hypot(pts[2][0] - pts[0][0], pts[2][1] - pts[0][1]))
    dst = [pts[0],
           (pts[0][0] + d_x, pts[0][1]),
           (pts[0][0], pts[0][1] + d_y),
           (pts[0][0] + d_x, pts[0][1] + d_y)]
    homo, _ = cv2.findHomography(np.float32(pts), np.float32(dst))
    np.savetxt(out_path, homo, "%.4f")
    return homo


def load_or_pick_bboxes(ref_img: np.ndarray, ref_bbox_path: str,
                        tracker_num: int) -> List[Tuple[int, int, int, int]]:
    """Load stored reference bboxes; interactive ROI selection if absent
    (reference get_video_ref, :84-113)."""
    if os.path.exists(ref_bbox_path):
        arr = np.loadtxt(ref_bbox_path).astype(int)
        if arr.ndim == 1:
            arr = arr[None]
        return [tuple(b) for b in arr[:tracker_num]]
    try:
        import cv2
        boxes = []
        win = "Select A Rect As Reference Obj"
        for t in range(tracker_num):
            while True:
                box = cv2.selectROI(win, ref_img, fromCenter=False)
                if box[2] > 0 and box[3] > 0:
                    break
            boxes.append(tuple(int(v) for v in box))
        cv2.destroyWindow(win)
        np.savetxt(ref_bbox_path, np.array(boxes), "%.4f")
        return boxes
    except Exception as e:
        raise RuntimeError(
            f"No reference bbox at {ref_bbox_path} and interactive selection "
            f"unavailable ({e}). Provide ref_bbox.txt.") from e


def _make_trackers(ref_img: np.ndarray, bboxes, device="cuda"
                   ) -> Optional[list]:
    """OpenCV CSRT when the installed OpenCV has it; otherwise the port's
    MOSSE tracker (:class:`..ops.tracker.MosseTracker`) on ``device``;
    otherwise None (static boxes). ``ref_img``: BGR uint8."""
    try:
        import cv2
        mk = getattr(cv2, "TrackerCSRT_create", None)
        if mk is None:
            mk = cv2.legacy.TrackerCSRT_create
        trackers = []
        for b in bboxes:
            t = mk()
            t.init(ref_img, tuple(int(v) for v in b))
            trackers.append(t)
        return trackers
    except Exception:
        pass
    try:
        from ..ops.tracker import MosseTracker
        trackers = []
        for b in bboxes:
            t = MosseTracker(device=device)
            t.init(ref_img, tuple(int(v) for v in b))
            trackers.append(t)
        warnings.warn("cv2 CSRT unavailable; using the first-party MOSSE "
                      "correlation tracker.")
        return trackers
    except Exception as e:
        warnings.warn(f"No tracker available ({e}); using static bboxes.")
        return None


def _fill(img: np.ndarray, y0: int, y1: int, x0: int, x1: int,
          color) -> None:
    h, w = img.shape[:2]
    y0, y1, x0, x1 = max(y0, 0), min(y1, h - 1), max(x0, 0), min(x1, w - 1)
    if y0 <= y1 and x0 <= x1:
        img[y0:y1 + 1, x0:x1 + 1] = color


def _segment(img: np.ndarray, p0, p1, color) -> None:
    """An axis-parallel segment 2 px thick, drawn as ``cv2.line(...,
    thickness=2)`` draws it: a 3-px band with a one-pixel cross at each
    end."""
    (x0, y0), (x1, y1) = p0, p1
    if y0 == y1:
        _fill(img, y0 - 1, y0 + 1, min(x0, x1), max(x0, x1), color)
    else:
        _fill(img, min(y0, y1), max(y0, y1), x0 - 1, x0 + 1, color)
    for x, y in (p0, p1):
        _fill(img, y - 1, y + 1, x, x, color)
        _fill(img, y, y, x - 1, x + 1, color)


def _rectangle(img: np.ndarray, x: int, y: int, w: int, h: int,
               color) -> None:
    """``cv2.rectangle(img, (x, y), (x + w, y + h), color, 2)``."""
    pts = [(x, y), (x + w, y), (x + w, y + h), (x, y + h)]
    for i in range(4):
        _segment(img, pts[i], pts[(i + 1) % 4], color)


def _timestamp(path: str, fmt: str, i: int) -> datetime:
    """The frame's time from its file name, else ``i`` seconds past the
    epoch (local time)."""
    name = os.path.splitext(os.path.basename(path))[0]
    try:
        return datetime.strptime(name, fmt)
    except ValueError:
        return datetime.fromtimestamp(i)


def write_levels_csv(levels: Sequence[Sequence[float]],
                     timestamps: Sequence[datetime], tracker_num: int,
                     out_dir: str) -> Tuple[str, Dict[str, np.ndarray]]:
    """Smooth each tracker's levels over time (Gaussian, sigma 2 frames,
    nearest edges), average the trackers (NaN-aware) and write
    ``<out_dir>/waterlevel.csv``: the timestamps as the index, then
    ``est_ref<t>_px`` and ``est_avg_px``, NaN as an empty field, the
    layout ``pandas.DataFrame.to_csv`` gives the JAX package's. Returns
    (path, columns)."""
    from scipy.ndimage import gaussian_filter1d

    wl = np.array(levels, np.float64)
    cols = {}
    for t in range(tracker_num):
        wl[:, t] = gaussian_filter1d(wl[:, t], sigma=2.0, mode="nearest")
        cols[f"est_ref{t}_px"] = wl[:, t]
    cols["est_avg_px"] = np.nanmean(wl, axis=1)
    csv_path = os.path.join(out_dir, "waterlevel.csv")
    with open(csv_path, "w", newline="") as f:
        out = csv.writer(f)
        out.writerow([""] + list(cols))
        for i, ts in enumerate(timestamps):
            out.writerow([str(ts)] + [
                "" if np.isnan(c[i]) else repr(float(c[i]))
                for c in cols.values()])
    return csv_path, cols


def est_by_reference(img_list: Sequence[str], water_mask_list: Sequence[str],
                     out_dir: str, record_dir: str, test_name: str,
                     viz: bool = True, device="cuda") -> str:
    """Returns the path of the waterlevel CSV. Frames are read as BGR, as
    OpenCV reads them; with ``viz`` each frame's overlay, reference boxes
    and waterline marks go to ``<out_dir>/viz/<name>.png``."""
    from PIL import Image

    device = resolve_device(device)
    prof = site_profile(test_name)
    os.makedirs(out_dir, exist_ok=True)
    viz_dir = os.path.join(out_dir, "viz")
    if viz:
        os.makedirs(viz_dir, exist_ok=True)

    homo_mat = None
    if prof.enable_calib:
        rec = os.path.join(record_dir, test_name, "homo_mat.txt")
        local = os.path.join(out_dir, "homo_mat.txt")
        if os.path.exists(rec):
            shutil.copyfile(rec, local)
        homo_mat = load_or_pick_homography(img_list[0], local)

    rec_bbox = os.path.join(record_dir, test_name, "ref_bbox.txt")
    local_bbox = os.path.join(out_dir, "ref_bbox.txt")
    if os.path.exists(rec_bbox):
        shutil.copyfile(rec_bbox, local_bbox)

    ref_bboxes = None
    trackers = None
    waterlevels: List[List[float]] = []
    timestamps: List[datetime] = []

    prev = [0.0] * prof.tracker_num
    warps = {}       # frame size -> the homography's bilinear map
    for i, (img_path, mask_path) in enumerate(zip(img_list, water_mask_list)):
        img = np.ascontiguousarray(load_image(img_path)[..., ::-1])
        mask_t = torch.from_numpy(load_mask(mask_path).copy()).to(device)
        if homo_mat is not None:
            hw = img.shape[:2]
            if hw not in warps:
                warps[hw] = perspective_map(homo_mat, hw, device=device)
            img = warps[hw](torch.from_numpy(img).to(device)).cpu().numpy()
            mask_t = warp_perspective_mask(mask_t, homo_mat)
        mask = mask_t.cpu().numpy()

        if ref_bboxes is None:
            ref_bboxes = load_or_pick_bboxes(img, local_bbox, prof.tracker_num)
            if prof.enable_tracker:
                trackers = _make_trackers(img, ref_bboxes, device)

        name = os.path.splitext(os.path.basename(img_path))[0]
        timestamps.append(_timestamp(img_path, prof.time_fmt, i))

        if trackers is not None:
            new_boxes = []
            for t, tr in enumerate(trackers):
                ok, box = tr.update(img)
                if ok:
                    new_boxes.append(tuple(int(v) for v in box))
                else:
                    warnings.warn(f"Tracker {t} failed at frame {name}.")
                    new_boxes.append(ref_bboxes[t])
            ref_bboxes = new_boxes

        viz_img = add_overlay(img, mask, COLOR_PALETTE) if viz else None
        est = list(prev)
        # each box's bottom centre (reference_tracking.py:197)
        cols = [int(x + w / 2) for x, y, w, h in ref_bboxes]
        rows = [int(y + h) for x, y, w, h in ref_bboxes]
        hits = waterline_below_batch(
            mask_t, torch.tensor(cols, dtype=torch.int32, device=device),
            torch.tensor(rows, dtype=torch.int32, device=device),
            water_label=WATER_LABEL_ID).tolist()
        for t, (x, y, w, h) in enumerate(ref_bboxes):
            if hits[t] < mask.shape[0]:
                level = hits[t] - rows[t]
                est[t] = float("nan") if level == 1 else float(level)
                if viz_img is not None and level != 1:
                    _segment(viz_img, (cols[t], rows[t]), (cols[t], hits[t]),
                             LINE_COLOR)
            if viz_img is not None:
                _rectangle(viz_img, x, y, w, h, BOX_COLOR)
        waterlevels.append(est)
        prev = est
        if viz_img is not None:
            Image.fromarray(np.ascontiguousarray(viz_img[..., ::-1])).save(
                os.path.join(viz_dir, f"{name}.png"))

    csv_path, cols = write_levels_csv(waterlevels, timestamps,
                                      prof.tracker_num, out_dir)
    _plot_hydrograph(cols, timestamps, prof, out_dir)
    return csv_path


def _plot_hydrograph(cols, timestamps, prof, out_dir):
    """``waterlevel_px.png``: the average level (and each tracker's, when
    there are several) against time. ``cols``: column name -> values."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.dates as mdates
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(20, 10))
    ax = fig.add_subplot(111)
    ax.plot(timestamps, cols["est_avg_px"], "o", label="Average")
    if prof.tracker_num > 1:
        for t in range(prof.tracker_num):
            ax.plot(timestamps, cols[f"est_ref{t}_px"], "o",
                    label=f"Estimate by ref {t}")
        ax.legend(loc="lower right", fontsize=24)
    unit, interval = prof.tick
    locator = (mdates.HourLocator(interval=interval) if unit == "hour"
               else mdates.MinuteLocator(interval=interval))
    ax.xaxis.set_major_locator(locator)
    ax.xaxis.set_major_formatter(mdates.DateFormatter("%m-%d %H:%M"))
    ax.set_ylabel("Estimated Water Level (pixel)", fontsize=24)
    plt.setp(ax.get_xticklabels(), rotation=45, ha="right", fontsize=24)
    plt.setp(ax.get_yticklabels(), fontsize=24)
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, "waterlevel_px.png"), dpi=300)
    plt.close(fig)
