"""Physical constants and site profiles as data (a copy of
``vfloodnet_tpu.core.config``, which the port does not import).

Per-site reference-tracking settings (tracker on or off, homography
calibration, number of reference objects, hydrograph ticks, frame-name
time format) are rows of :data:`SITE_PROFILES`, matched by a substring of
the test name.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

# --- Physical constants (reference object_detection.py:27-35) -------------
STOPSIGN_META = {
    "size_cm": 79.0,          # 75cm plate + 2*2cm white border
    "pole_height_cm": 215.9,  # 85 in
}
PEOPLE_META = {
    "man_height_cm": 175.4,
    "woman_height_cm": 161.7,
}
WATER_LABEL_ID = 1

OBJECT_COLORS = {
    "background": (0, 0, 0),
    "stopsign": (128, 128, 0),
    "people": (0, 128, 128),
}

# Detection operating points (object_detection.py:19,24,198)
STOPSIGN_CONF_THRES = 0.5
PEOPLE_CONF_THRES = 0.7
PEOPLE_BOX_SCORE_MIN = 0.9
STOPSIGN_COCO_CLASS = 11  # COCO class index for stop sign
PERSON_COCO_CLASS = 0     # COCO class index for person


@dataclasses.dataclass(frozen=True)
class SiteProfile:
    """Per-site reference-tracking configuration
    (reference_tracking.py:117-140)."""
    name: str
    enable_tracker: bool = True
    enable_calib: bool = True
    tracker_num: int = 1
    # Hydrograph axis ticks: (unit, interval) with unit in {hour, minute}
    tick: Tuple[str, int] = ("minute", 3)
    # Video fps for result rendering (cvt_imgs_to_video.py:66-73)
    fps: float = 10.0
    # Timestamp format of frame filenames
    time_fmt: str = "%Y-%m-%d-%H-%M-%S"


SITE_PROFILES: Dict[str, SiteProfile] = {
    "houston": SiteProfile("houston", enable_tracker=False,
                           enable_calib=False, tracker_num=2,
                           tick=("hour", 6), fps=10.0),
    "boston": SiteProfile("boston", enable_tracker=True, enable_calib=True,
                          tracker_num=1, tick=("hour", 6), fps=10.0),
    "LSU": SiteProfile("LSU", enable_tracker=False, enable_calib=False,
                       tracker_num=1, tick=("minute", 3), fps=2.0),
}

DEFAULT_SITE = SiteProfile("default")


def site_profile(test_name: str) -> SiteProfile:
    """Match by substring, like the reference dispatch."""
    for key, prof in SITE_PROFILES.items():
        if key in test_name:
            return prof
    return DEFAULT_SITE
