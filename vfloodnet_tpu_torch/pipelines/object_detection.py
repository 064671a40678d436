"""Water depth from a detected stop sign (counterpart of the stop-sign half
of ``vfloodnet_tpu.pipelines.object_detection``): detect stop signs, fit an
octagon to the instance mask, take the homography from the canonical sign
template, project the pole, march along it to the water mask; depth =
submerged ratio x 215.9 cm.

:func:`stopsign_depth` is the per-image work, arrays in and out (the ratio,
the depth and the three canvases), so it runs where nothing can decode or
write an image, as on the card's machine. :func:`waterdepth_by_stopsign`
writes its canvases, :func:`est_by_obj_detection` reads frames (PIL RGB,
reversed to BGR: byte-equal to ``cv2.imread`` for a PNG) and masks and
writes ``waterdepth.txt``. The geometry is numpy on the host: it is
O(vertices), not O(pixels). The contour calls are ``ops/contour.py``'s and
the lines ``utils/draw.py``'s: the card's machine has no cv2.

The people half (Keypoint R-CNN, the body mesh) waits for ROADMAP A3.
"""

from __future__ import annotations

import os
import warnings
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..core.config import STOPSIGN_COCO_CLASS, STOPSIGN_META, WATER_LABEL_ID
from ..ops.contour import (approx_poly_dp, arc_length, contour_area,
                           find_external_contours)
from ..ops.homography import find_homography, perspective_transform
from ..utils.draw import line


@dataclass
class Instances:
    """Detector output for one image (all numpy, host-side)."""
    boxes: np.ndarray        # [N, 4] xyxy
    scores: np.ndarray       # [N]
    classes: np.ndarray      # [N] int
    masks: Optional[np.ndarray] = None      # [N, H, W] uint8

    def __len__(self):
        return len(self.boxes)


THICKNESS = 6
TEMPLATE_COLOR = (0, 200, 0)      # BGR
SUBMERGED_COLOR = (0, 0, 200)
WATER_COLOR = (200, 0, 0)


def make_stopsign_template(pts_n: int = 8, plate_radius: float = 50.0,
                           plate_center=(150.0, 75.0)):
    """Canonical octagon and pole: (plate_pts [8, 2], pole_top [2],
    pole_bottom [2])."""
    step = 2.0 * np.pi / pts_n
    pos = step / 2.0
    pts = []
    for _ in range(pts_n):
        pts.append((plate_radius * np.cos(pos) + plate_center[0],
                    plate_radius * np.sin(pos) + plate_center[1]))
        pos += step
    plate = np.array(pts)
    plate_height = 2.0 * np.cos(step / 2.0) * plate_radius
    pole_len = plate_height / STOPSIGN_META["size_cm"] * \
        STOPSIGN_META["pole_height_cm"]
    pole_top = plate[1:3].mean(axis=0)
    pole_bottom = pole_top + np.array([0.0, pole_len])
    return plate, pole_top, pole_bottom


def fit_octagon(mask: np.ndarray) -> Optional[np.ndarray]:
    """Fit an 8-gon to the largest outer contour of a binary mask (the
    first of equal areas, as Python's ``max`` takes it); vertices sorted by
    polar angle around their centroid. Returns [8, 2] float32 or None."""
    cnts = find_external_contours(mask)
    if not cnts:
        return None
    cnt = max(cnts, key=contour_area)
    approx = approx_poly_dp(cnt, 0.02 * arc_length(cnt))
    if approx.shape[0] != 8:
        return None
    x = approx[:, 0, 0].astype(np.float64)
    y = approx[:, 0, 1].astype(np.float64)
    xc, yc = x.mean(), y.mean()
    r = np.sqrt((x - xc) ** 2 + (y - yc) ** 2)
    ang = np.where((y - yc) > 0, np.arccos(np.clip((x - xc) / r, -1, 1)),
                   2 * np.pi - np.arccos(np.clip((x - xc) / r, -1, 1)))
    order = np.argsort(ang)
    return np.stack([x[order], y[order]], axis=1).astype(np.float32)


def march_pole_to_water(pole_top: np.ndarray, pole_bottom: np.ndarray,
                        water_mask: np.ndarray) -> Tuple[np.ndarray, float]:
    """Sample every integer step from the pole's top to its bottom and
    return the first point on water, stopping at the image border.
    Returns (hit_point [2], submerged_ratio)."""
    length = float(np.linalg.norm(pole_bottom - pole_top))
    n = max(int(length), 1)
    direction = (pole_bottom - pole_top) / max(length, 1e-9)
    steps = np.arange(n)[:, None]
    pts = (pole_top[None] + direction[None] * steps).astype(int)   # [n, 2]
    h, w = water_mask.shape
    inside = ((pts[:, 0] > 0) & (pts[:, 1] > 0)
              & (pts[:, 0] < w) & (pts[:, 1] < h))
    vals = np.zeros(n, np.uint8)
    vals[inside] = water_mask[pts[inside, 1], pts[inside, 0]]
    first_oob = np.argmax(~inside) if (~inside).any() else n
    hits = np.nonzero(vals[:first_oob] == WATER_LABEL_ID)[0]
    if hits.size == 0:
        return pole_bottom.astype(int), 0.0
    hit = pts[hits[0]]
    ratio = float(np.linalg.norm(hit - pole_bottom) / max(length, 1e-9))
    return hit, ratio


def _draw_sign(canvas: np.ndarray, proj_plate: np.ndarray,
               proj_top: np.ndarray, proj_bottom: np.ndarray,
               hit: np.ndarray) -> None:
    for j in range(8):
        line(canvas, proj_plate[j], proj_plate[(j + 1) % 8], TEMPLATE_COLOR,
             THICKNESS)
    line(canvas, proj_top.astype(int), proj_bottom.astype(int),
         TEMPLATE_COLOR, THICKNESS)
    line(canvas, hit.astype(int), proj_bottom.astype(int), SUBMERGED_COLOR,
         THICKNESS)


def stopsign_depth(img: np.ndarray, instances: Instances,
                   water_mask: Optional[np.ndarray]
                   ) -> Tuple[float, float, Optional[Dict[str, np.ndarray]]]:
    """The first usable stop sign of one BGR image: (submerged ratio, depth
    in cm, BGR canvases {"pred", "template", "est"}); (-1, -1, None) when
    there is none or no water mask."""
    plate, pole_top, pole_bottom = make_stopsign_template()
    if water_mask is None:
        return -1.0, -1.0, None
    for i in range(len(instances)):
        if int(instances.classes[i]) != STOPSIGN_COCO_CLASS:
            continue
        if instances.masks is None:
            continue
        oct_pts = fit_octagon(instances.masks[i])
        if oct_pts is None:
            continue
        h = find_homography(plate, oct_pts)
        proj = perspective_transform(
            np.concatenate([plate, pole_top[None], pole_bottom[None]]), h)
        proj_plate = proj[:8].astype(int)
        proj_top, proj_bottom = proj[8], proj[9]
        hit, ratio = march_pole_to_water(proj_top, proj_bottom, water_mask)
        depth_cm = ratio * STOPSIGN_META["pole_height_cm"]

        pred = img.copy()
        _draw_sign(pred, proj_plate, proj_top, proj_bottom, hit)
        tmpl = np.full((300, 400, 3), 255, np.uint8)
        ipts = plate.astype(int)
        for j in range(8):
            line(tmpl, ipts[j], ipts[(j + 1) % 8], TEMPLATE_COLOR, THICKNESS)
        t_top, t_bot = pole_top.astype(int), pole_bottom.astype(int)
        line(tmpl, t_top, t_bot, TEMPLATE_COLOR, THICKNESS)
        water_y = int(pole_top[1] + (1.0 - ratio)
                      * (pole_bottom[1] - pole_top[1]))
        line(tmpl, (t_top[0], water_y), t_bot, SUBMERGED_COLOR, THICKNESS)
        line(tmpl, (100, water_y), (300, water_y), WATER_COLOR, THICKNESS)
        est = np.full_like(img, 255)
        _draw_sign(est, proj_plate, proj_top, proj_bottom, hit)
        return ratio, depth_cm, {"pred": pred, "template": tmpl, "est": est}
    return -1.0, -1.0, None


def _write_bgr(path: str, img_bgr: np.ndarray) -> None:
    from PIL import Image
    Image.fromarray(np.ascontiguousarray(img_bgr[..., ::-1])).save(path)


def waterdepth_by_stopsign(img: np.ndarray, instances: Instances,
                           water_mask: Optional[np.ndarray],
                           result_dir: str, img_name: str
                           ) -> Tuple[float, float]:
    """:func:`stopsign_depth`, writing ``<img_name>_{pred,template,est}.png``
    to ``result_dir``; (-1, -1) when there is no usable stop sign."""
    ratio, depth, canvases = stopsign_depth(img, instances, water_mask)
    if canvases is not None:
        os.makedirs(result_dir, exist_ok=True)
        for kind, canvas in canvases.items():
            _write_bgr(os.path.join(result_dir, f"{img_name}_{kind}.png"),
                       canvas)
    return ratio, depth


def est_by_obj_detection(img_list: Sequence[str],
                         water_mask_list: Sequence[str], out_dir: str,
                         opt: str, det_model_path: Optional[str] = None,
                         device="cuda") -> str:
    """Depth estimation over a list of stills; writes
    ``<out_dir>/waterdepth.txt`` rows (name, ratio, depth in cm) and
    returns its path. ``opt`` must be "stopsign"."""
    from ..utils import load_image, load_mask

    if opt != "stopsign":
        raise NotImplementedError(
            f"--opt {opt} is not ported to vfloodnet_tpu_torch yet (people: "
            "ROADMAP A3)")
    from ..models.detection import load_default_detector
    detector = load_default_detector(opt, det_model_path, device=device)
    result_dir = os.path.join(out_dir, "result")
    os.makedirs(result_dir, exist_ok=True)
    rows = []
    for img_path, mask_path in zip(img_list, water_mask_list):
        name = os.path.splitext(os.path.basename(img_path))[0]
        img = np.ascontiguousarray(load_image(img_path)[..., ::-1])
        water_mask = load_mask(mask_path) if os.path.exists(mask_path) \
            else None
        if water_mask is None:
            warnings.warn(f"missing water mask for {name}")
        inst = detector(img)
        ratio, depth = waterdepth_by_stopsign(img, inst, water_mask,
                                              result_dir, name)
        rows.append((name, ratio, depth))
    out_path = os.path.join(out_dir, "waterdepth.txt")
    with open(out_path, "w") as f:
        for name, ratio, depth in rows:
            f.write(f"{name}\t{ratio:.4f}\t{depth:.4f}\n")
    return out_path
