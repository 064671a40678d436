"""Synthetic stop-sign and person scenes for the detector and body-mesh
trainers (counterpart of ``vfloodnet_tpu.data.detection_dataset``), drawn
without cv2: the card's machine has none.

Scenes: a red octagonal stop-sign plate on a pole, or a standing figure,
over a noisy sky/ground background, optionally with a water band. GT =
box + instance mask + COCO class (+ the person's COCO-17 keypoints), in
the fixed-capacity layout the trainer expects. The JAX package draws on a
float32 BGR canvas with cv2; here ``utils/draw.py`` draws the same pixels
(``line``, ``fill_poly``, ``polylines``, ``fill_rect``, ``fill_circle``),
and the random draws are numpy's in the same order, so a scene is the JAX
package's bit for bit.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from ..core.config import (PERSON_COCO_CLASS, STOPSIGN_COCO_CLASS,
                           WATER_LABEL_ID)
from ..utils.draw import fill_circle, fill_poly, fill_rect, line, polylines

GT_CAP = 8      # fixed GT capacity per image (static shapes)


def octagon_vertices(cx: float, cy: float, radius: float) -> np.ndarray:
    """[8, 2] vertices of a flat-topped regular octagon (same polar layout
    as pipelines.object_detection.make_stopsign_template)."""
    step = 2.0 * np.pi / 8.0
    pos = step / 2.0
    pts = []
    for _ in range(8):
        pts.append((radius * np.cos(pos) + cx, radius * np.sin(pos) + cy))
        pos += step
    return np.asarray(pts, np.float32)


def render_stopsign_scene(rng: np.random.Generator, size: int = 320,
                          water_level: Optional[float] = None
                          ) -> Dict[str, np.ndarray]:
    """One synthetic scene.

    Returns dict with:
      image       [S, S, 3] float32 BGR in 0..255 (detector input space)
      boxes       [GT_CAP, 4] xyxy
      classes     [GT_CAP] int32 (COCO ids)
      masks       [GT_CAP, S, S] float32 {0, 1}
      valid       [GT_CAP] bool
      water_mask  [S, S] uint8 (WATER_LABEL_ID where water), all zero
                  unless ``water_level`` (0..1, fraction of image height
                  from the bottom) is given
      pole_bottom [2] (x, y) of the pole base in pixels
    """
    s = size
    # sky -> ground vertical gradient + noise, in BGR
    t = np.linspace(0.0, 1.0, s, dtype=np.float32)[:, None]
    sky = np.array([200.0, 160.0, 120.0], np.float32)      # light blue-ish
    ground = np.array([60.0, 100.0, 90.0], np.float32)     # muddy green
    img = sky[None, None] * (1 - t[..., None]) + ground[None, None] * t[..., None]
    img = img + rng.normal(0.0, 12.0, (s, s, 3)).astype(np.float32)

    # plate geometry: radius and center chosen so plate + pole fit
    radius = float(rng.uniform(0.09, 0.16)) * s
    cx = float(rng.uniform(0.3, 0.7)) * s
    cy = float(rng.uniform(0.25, 0.45)) * s
    verts = octagon_vertices(cx, cy, radius)

    # pole: from the plate's bottom edge midpoint straight down
    plate_h = 2.0 * np.cos(np.pi / 8.0) * radius
    pole_top = verts[1:3].mean(axis=0)
    pole_len = plate_h / 75.0 * 215.0        # STOPSIGN_META proportions
    pole_bottom = pole_top + np.array([0.0, pole_len], np.float32)
    pole_bottom[1] = min(pole_bottom[1], s - 2.0)

    line(img, tuple(pole_top.astype(int)), tuple(pole_bottom.astype(int)),
         (90.0, 90.0, 90.0), max(2, int(radius * 0.14)))

    # plate: red fill, thin white rim (BGR)
    ivrt = verts.astype(np.int32)
    fill_poly(img, ivrt, (30.0, 20.0, 200.0))
    polylines(img, ivrt, True, (240.0, 240.0, 240.0),
              max(1, int(radius * 0.08)))

    mask = np.zeros((s, s), np.uint8)
    fill_poly(mask, ivrt, 1)

    water_mask = np.zeros((s, s), np.uint8)
    if water_level is not None:
        wy = int(round(s * (1.0 - water_level)))
        water_mask[wy:, :] = WATER_LABEL_ID
        # water visually: blue-ish band with ripple noise
        img[wy:, :] = (np.array([150.0, 90.0, 40.0], np.float32)[None, None]
                       + rng.normal(0.0, 10.0, (s - wy, s, 3)))

    img = np.clip(img, 0.0, 255.0).astype(np.float32)

    ys, xs = np.nonzero(mask)
    box = np.array([xs.min(), ys.min(), xs.max() + 1, ys.max() + 1],
                   np.float32)

    boxes = np.zeros((GT_CAP, 4), np.float32)
    classes = np.zeros((GT_CAP,), np.int32)
    masks = np.zeros((GT_CAP, s, s), np.float32)
    valid = np.zeros((GT_CAP,), bool)
    boxes[0] = box
    classes[0] = STOPSIGN_COCO_CLASS
    masks[0] = mask.astype(np.float32)
    valid[0] = True

    return {"image": img, "boxes": boxes, "classes": classes,
            "masks": masks, "valid": valid, "water_mask": water_mask,
            "pole_bottom": pole_bottom}


def render_person_scene(rng: np.random.Generator, size: int = 320,
                        water_level: Optional[float] = None
                        ) -> Dict[str, np.ndarray]:
    """One synthetic standing-person scene (people-depth analogue of
    :func:`render_stopsign_scene`; reference people path:
    estimation/object_detection.py:191-243,319-398).

    A person = head (circle) + torso (rounded rectangle) + two legs + two
    arms in contrasting clothing colours, feet on the ground line. GT =
    person bbox + silhouette mask + COCO class 0. ``water_level`` (0..1
    fraction of the image height from the bottom) adds a water band that
    partially submerges the legs. Extra keys ``head_y``/``feet_y`` give the
    true body extent for regressor training / eval.
    """
    s = size
    t = np.linspace(0.0, 1.0, s, dtype=np.float32)[:, None]
    sky = np.array([210.0, 170.0, 130.0], np.float32)
    ground = np.array([70.0, 95.0, 85.0], np.float32)
    img = sky[None, None] * (1 - t[..., None]) \
        + ground[None, None] * t[..., None]
    img = img + rng.normal(0.0, 12.0, (s, s, 3)).astype(np.float32)

    # body proportions (head:torso:legs ~ 1:3:4 of total height)
    height = float(rng.uniform(0.45, 0.7)) * s
    cx = float(rng.uniform(0.3, 0.7)) * s
    feet_y = float(rng.uniform(0.78, 0.95)) * s
    head_y = feet_y - height
    head_r = height * 0.065
    torso_w = height * float(rng.uniform(0.16, 0.22))
    torso_top = head_y + 2.2 * head_r
    torso_bot = head_y + height * 0.52
    leg_w = torso_w * 0.38

    skin = (150.0, 170.0, 210.0)                      # BGR skin-ish
    shirt = tuple(float(c) for c in rng.uniform(40, 230, 3))
    pants = tuple(float(c) for c in rng.uniform(20, 120, 3))

    mask = np.zeros((s, s), np.uint8)

    def draw(shape, *args, color=None):
        shape(img, *args, color)
        shape(mask, *args, 1)

    # legs (slight stance spread)
    spread = leg_w * float(rng.uniform(0.6, 1.2))
    for sgn in (-1.0, 1.0):
        x0 = int(cx + sgn * spread - leg_w / 2)
        x1 = int(cx + sgn * spread + leg_w / 2)
        draw(fill_rect, (x0, int(torso_bot)), (x1, int(feet_y)),
             color=pants)
    # torso
    draw(fill_rect, (int(cx - torso_w), int(torso_top)),
         (int(cx + torso_w), int(torso_bot)), color=shirt)
    # arms (straight down from the shoulders)
    arm_w = max(2, int(leg_w * 0.7))
    for sgn in (-1.0, 1.0):
        ax = int(cx + sgn * (torso_w + arm_w * 0.6))
        draw(fill_rect, (ax - arm_w // 2, int(torso_top + head_r)),
             (ax + arm_w // 2, int(torso_bot)), color=skin)
    # head
    draw(fill_circle, (int(cx), int(head_y + head_r)), int(head_r),
         color=skin)

    water_mask = np.zeros((s, s), np.uint8)
    if water_level is not None:
        wy = int(round(s * (1.0 - water_level)))
        water_mask[wy:, :] = WATER_LABEL_ID
        img[wy:, :] = (np.array([150.0, 90.0, 40.0], np.float32)[None, None]
                       + rng.normal(0.0, 10.0, (s - wy, s, 3)))

    img = np.clip(img, 0.0, 255.0).astype(np.float32)

    ys, xs = np.nonzero(mask)
    box = np.array([xs.min(), ys.min(), xs.max() + 1, ys.max() + 1],
                   np.float32)

    # COCO-17 keypoints (x, y, vis) from the figure geometry — nose/eyes/
    # ears on the head disc, shoulders/elbows/wrists on the arm columns,
    # hips/knees/ankles on the leg columns. All visible: the water band is
    # opaque but a person detector must still localize submerged joints
    # (that extrapolation is exactly what the people-depth chain needs).
    hc_y = head_y + head_r
    sh_y = torso_top + head_r
    arm_x = torso_w + arm_w * 0.6
    knee_y = 0.5 * (torso_bot + feet_y)
    kp = np.array([
        (cx, hc_y),                                     # nose
        (cx + 0.35 * head_r, hc_y - 0.2 * head_r),      # left eye
        (cx - 0.35 * head_r, hc_y - 0.2 * head_r),      # right eye
        (cx + 0.8 * head_r, hc_y),                      # left ear
        (cx - 0.8 * head_r, hc_y),                      # right ear
        (cx + 0.8 * torso_w, sh_y),                     # left shoulder
        (cx - 0.8 * torso_w, sh_y),                     # right shoulder
        (cx + arm_x, 0.5 * (sh_y + torso_bot)),         # left elbow
        (cx - arm_x, 0.5 * (sh_y + torso_bot)),         # right elbow
        (cx + arm_x, torso_bot),                        # left wrist
        (cx - arm_x, torso_bot),                        # right wrist
        (cx + spread, torso_bot),                       # left hip
        (cx - spread, torso_bot),                       # right hip
        (cx + spread, knee_y),                          # left knee
        (cx - spread, knee_y),                          # right knee
        (cx + spread, feet_y - 1.0),                    # left ankle
        (cx - spread, feet_y - 1.0),                    # right ankle
    ], np.float32)
    keypoints0 = np.concatenate([kp, np.ones((17, 1), np.float32)], axis=1)

    boxes = np.zeros((GT_CAP, 4), np.float32)
    classes = np.zeros((GT_CAP,), np.int32)
    masks = np.zeros((GT_CAP, s, s), np.float32)
    valid = np.zeros((GT_CAP,), bool)
    keypoints = np.zeros((GT_CAP, 17, 3), np.float32)
    boxes[0] = box
    classes[0] = PERSON_COCO_CLASS
    masks[0] = mask.astype(np.float32)
    valid[0] = True
    keypoints[0] = keypoints0

    return {"image": img, "boxes": boxes, "classes": classes,
            "masks": masks, "valid": valid, "water_mask": water_mask,
            "keypoints": keypoints,
            "head_y": np.float32(head_y), "feet_y": np.float32(feet_y)}


class SyntheticPeopleDataset:
    """BatchLoader-compatible view over :func:`render_person_scene`."""

    def __init__(self, n: int = 512, size: int = 320, seed: int = 0):
        self.n = n
        self.size = size
        self.seed = seed

    def __len__(self) -> int:
        return self.n

    def get(self, idx: int, epoch: int = 0):
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed + 7, epoch, idx]))
        sc = render_person_scene(rng, self.size)
        return (sc["image"], sc["boxes"], sc["classes"], sc["masks"],
                sc["valid"].astype(np.float32), sc["keypoints"])

    __getitem__ = get


class SyntheticStopsignDataset:
    """BatchLoader-compatible view over :func:`render_stopsign_scene`."""

    def __init__(self, n: int = 512, size: int = 320, seed: int = 0):
        self.n = n
        self.size = size
        self.seed = seed

    def __len__(self) -> int:
        return self.n

    def get(self, idx: int, epoch: int = 0):
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch, idx]))
        sc = render_stopsign_scene(rng, self.size)
        return (sc["image"], sc["boxes"], sc["classes"], sc["masks"],
                sc["valid"].astype(np.float32))

    __getitem__ = get
