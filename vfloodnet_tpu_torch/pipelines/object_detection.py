"""Water depth from a detected reference object (counterpart of
``vfloodnet_tpu.pipelines.object_detection``):

- **stopsign**: detect stop signs, fit an octagon to the instance mask,
  take the homography from the canonical sign template, project the pole,
  march along it to the water mask; depth = submerged ratio x 215.9 cm.
- **people**: detect people, crop the first one scoring >= 0.9 to a 224 x
  224 square with its water-mask crop, regress the body mesh, label the
  projected vertices by the mask, place the water boundary on a standing
  template from the labels' medians; depth = ratio x 175.4 cm.

:func:`stopsign_depth` and :func:`people_depth` are the per-image work,
arrays in and out (the ratio, the depth and the canvases), so they run
where nothing can decode or write an image, as on the card's machine.
:func:`waterdepth_by_stopsign` and :func:`waterdepth_by_people` write their
canvases, :func:`est_by_obj_detection` reads frames (PIL RGB, reversed to
BGR: byte-equal to ``cv2.imread`` for a PNG) and masks and writes
``waterdepth.txt``. The geometry is numpy on the host: it is O(vertices),
not O(pixels). The contour calls are ``ops/contour.py``'s, the resizes
``ops/resize.py``'s and the lines and dots ``utils/draw.py``'s: the card's
machine has no cv2.
"""

from __future__ import annotations

import json
import os
import warnings
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.config import (PEOPLE_BOX_SCORE_MIN, PEOPLE_META,
                           STOPSIGN_COCO_CLASS, STOPSIGN_META, WATER_LABEL_ID)
from ..ops.contour import (approx_poly_dp, arc_length, contour_area,
                           find_external_contours)
from ..ops.homography import find_homography, perspective_transform
from ..ops.resize import cv2_linear_float, cv2_linear_u8, cv2_nearest
from ..utils.draw import dot, line


@dataclass
class Instances:
    """Detector output for one image (all numpy, host-side)."""
    boxes: np.ndarray        # [N, 4] xyxy
    scores: np.ndarray       # [N]
    classes: np.ndarray      # [N] int
    masks: Optional[np.ndarray] = None      # [N, H, W] uint8
    keypoints: Optional[np.ndarray] = None  # [N, K, 3]

    def __len__(self):
        return len(self.boxes)


Detector = Callable[[np.ndarray], Instances]
# a BGR uint8 crop [224, 224, 3] -> projected vertices [V, 2] in [-1, 1]
MeshRegressor = Callable[[np.ndarray], np.ndarray]


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


def _write_canvases(result_dir: str, img_name: str,
                    canvases: Dict[str, np.ndarray]) -> None:
    """Each BGR canvas to ``<result_dir>/<img_name>_<kind>.png``."""
    from PIL import Image
    os.makedirs(result_dir, exist_ok=True)
    for kind, canvas in canvases.items():
        Image.fromarray(np.ascontiguousarray(canvas[..., ::-1])).save(
            os.path.join(result_dir, f"{img_name}_{kind}.png"))


def waterdepth_by_stopsign(img: np.ndarray, instances: Instances,
                           water_mask: Optional[np.ndarray],
                           result_dir: str, img_name: str
                           ) -> Tuple[float, float]:
    """:func:`stopsign_depth`, writing ``<img_name>_{pred,template,est}.png``
    to ``result_dir``; (-1, -1) when there is no usable stop sign."""
    ratio, depth, canvases = stopsign_depth(img, instances, water_mask)
    if canvases is not None:
        _write_canvases(result_dir, img_name, canvases)
    return ratio, depth


# --------------------------------------------------------------------------
# People
# --------------------------------------------------------------------------

UNDER_COLOR = (0, 0, 200)
ABOVE_COLOR = (0, 200, 0)
BOUNDARY_COLOR = (200, 0, 0)


def crop_person(img: np.ndarray, water_mask: np.ndarray, box,
                scale_ratio: float = 1.5, out_size: int = 224):
    """A square crop around a person box, clamped to the image, resized to
    ``out_size`` (OpenCV's ``INTER_LINEAR``: the uint8 form for a uint8
    image, the float form for a float32 one, as the body-mesh trainer's
    rendered scenes are) with the water mask's crop (OpenCV's
    ``INTER_NEAREST``)."""
    img_h, img_w = img.shape[:2]
    x1, y1, x2, y2 = box
    cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
    radius = min(min(img_h, img_w),
                 scale_ratio * max(x2 - x1, y2 - y1)) / 2
    left, right = int(cx - radius), int(cx + radius)
    top, bottom = int(cy - radius), int(cy + radius)
    if left < 0:
        right -= left
        left = 0
    if right >= img_w:
        left -= (right - img_w)
        right = img_w
    if top < 0:
        bottom -= top
        top = 0
    if bottom >= img_h:
        top -= (bottom - img_h)
        bottom = img_h
    if img.dtype == np.uint8:
        crop = cv2_linear_u8(torch.from_numpy(np.ascontiguousarray(
            img[top:bottom, left:right])), (out_size, out_size)).numpy()
    else:
        crop = cv2_linear_float(img[top:bottom, left:right],
                                (out_size, out_size))
    mask_crop = cv2_nearest(water_mask[top:bottom, left:right],
                            (out_size, out_size))
    return crop, mask_crop


def predict_boundary(under_y: np.ndarray, above_y: np.ndarray
                     ) -> Optional[int]:
    """The water boundary from the template rows of the vertices under and
    above water: midway between the median of the 30 lowest above and the
    median of the 10 highest under below those."""
    if above_y.size == 0 or under_y.size == 0:
        return None
    above_bottom = np.median(np.sort(above_y)[-30:])
    under_sel = under_y[under_y > above_bottom]
    if under_sel.size == 0:
        return None
    under_top = np.median(np.sort(under_sel)[:10])
    return int((above_bottom + under_top) // 2)


def people_ratio(crop_mask: np.ndarray, pred_2d: np.ndarray,
                 template_2d: np.ndarray, resolution: int = 224
                 ) -> Tuple[Optional[float], Dict[str, np.ndarray]]:
    """The submerged ratio from projected mesh vertices against the
    standing template (``pred_2d``, ``template_2d``: [V, 2] in [-1, 1]),
    None when the labels place no boundary; and the BGR canvases
    {"est", "template"}: each vertex a dot, red under water, green above,
    the boundary a blue line on the template."""
    pred = np.clip(((pred_2d + 1) * resolution / 2).astype(int), 0,
                   resolution - 1)
    template = np.clip(((template_2d + 1) * resolution / 2).astype(int), 0,
                       resolution - 1)
    t_top = template[:, 1].min()
    t_height = max(template[:, 1].max() - t_top, 1)
    labels = crop_mask[pred[:, 1], pred[:, 0]]
    under = labels == WATER_LABEL_ID
    boundary = predict_boundary(template[under, 1], template[~under, 1])

    est = np.full((resolution, resolution, 3), 255, np.uint8)
    tmpl = np.full((resolution, resolution, 3), 255, np.uint8)
    for j in range(pred.shape[0]):
        color = UNDER_COLOR if under[j] else ABOVE_COLOR
        dot(est, pred[j], color, 2)
        dot(tmpl, template[j], color, 2)
    if boundary is not None:
        line(tmpl, (resolution // 4, int(boundary)),
             (3 * resolution // 4, int(boundary)), BOUNDARY_COLOR, 2)
    canvases = {"est": est, "template": tmpl}
    if boundary is None:
        return None, canvases
    return 1.0 - (boundary - t_top) / t_height, canvases


def waterdepth_by_people(crop_mask: np.ndarray, pred_2d: np.ndarray,
                         template_2d: np.ndarray, resolution: int = 224,
                         result_dir: Optional[str] = None,
                         img_name: str = "") -> Optional[float]:
    """:func:`people_ratio`; with ``result_dir``, writes
    ``<img_name>_{est,template}.png`` there."""
    ratio, canvases = people_ratio(crop_mask, pred_2d, template_2d,
                                   resolution)
    if result_dir:
        _write_canvases(result_dir, img_name, canvases)
    return ratio


def people_depth(img: np.ndarray, instances: Instances,
                 water_mask: np.ndarray, mesh_regressor: MeshRegressor,
                 template_2d: np.ndarray
                 ) -> Tuple[Optional[float], Optional[float],
                            Optional[Dict[str, np.ndarray]]]:
    """The first person scoring >= 0.9 in one BGR image: (submerged ratio,
    depth in cm, canvases {"est", "template"}). Only that person is tried:
    the ratio and depth are None when its vertices place no boundary, and
    all three when no person scores 0.9."""
    for i in range(len(instances)):
        if instances.scores[i] < PEOPLE_BOX_SCORE_MIN:
            continue
        crop, mask_crop = crop_person(img, water_mask, instances.boxes[i])
        ratio, canvases = people_ratio(mask_crop, mesh_regressor(crop),
                                       template_2d)
        depth = None if ratio is None else ratio * PEOPLE_META[
            "man_height_cm"]
        return ratio, depth, canvases
    return None, None, None


def load_template_3d(path: Optional[str] = None) -> np.ndarray:
    """The standing body's projected vertices [V, 2] in [-1, 1]: the
    first two columns of a JSON list at ``path``, else the JAX package's
    synthetic silhouette (431 vertices down a vertical ellipse, from
    ``RandomState(0)``)."""
    if path and os.path.exists(path):
        with open(path) as f:
            return np.array(json.load(f))[:, :2]
    rng = np.random.RandomState(0)
    v = 431
    y = np.linspace(-0.95, 0.95, v)
    x = 0.18 * np.sin(np.linspace(0, np.pi, v)) * rng.uniform(0.3, 1.0, v) \
        * np.sign(rng.randn(v))
    return np.stack([x, y], axis=1)


def est_by_obj_detection(img_list: Sequence[str],
                         water_mask_list: Sequence[str], out_dir: str,
                         opt: str, detector: Optional[Detector] = None,
                         mesh_regressor: Optional[MeshRegressor] = None,
                         template_3d_path: Optional[str] = None,
                         det_model_path: Optional[str] = None,
                         device="cuda") -> str:
    """Depth estimation over a list of stills; writes
    ``<out_dir>/waterdepth.txt`` rows (name, ratio, depth in cm) and
    returns its path. ``opt``: "stopsign" or "people". ``detector`` and
    ``mesh_regressor`` default to :func:`load_default_detector` (of
    ``det_model_path``) and :func:`load_default_mesh_regressor` on
    ``device``; ``template_3d_path`` names the standing template (default:
    the synthetic one)."""
    from ..utils import load_image, load_mask

    if opt not in ("stopsign", "people"):
        raise NotImplementedError(opt)
    if detector is None:
        from ..models.detection import load_default_detector
        detector = load_default_detector(opt, det_model_path, device=device)
    if opt == "people":
        if mesh_regressor is None:
            from ..models.metro import load_default_mesh_regressor
            mesh_regressor = load_default_mesh_regressor(device=device)
        template_2d = load_template_3d(template_3d_path)
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
        if opt == "stopsign":
            inst = detector(img)
            ratio, depth = waterdepth_by_stopsign(img, inst, water_mask,
                                                  result_dir, name)
            rows.append((name, ratio, depth))
            continue
        if water_mask is None:
            continue
        ratio, depth, canvases = people_depth(img, detector(img), water_mask,
                                              mesh_regressor, template_2d)
        if canvases is not None:
            _write_canvases(result_dir, name, canvases)
        if ratio is None:
            print(f"No usable person detection in {name}. Skip.")
        else:
            rows.append((name, ratio, depth))
    out_path = os.path.join(out_dir, "waterdepth.txt")
    with open(out_path, "w") as f:
        for name, ratio, depth in rows:
            f.write(f"{name}\t{ratio:.4f}\t{depth:.4f}\n")
    return out_path
