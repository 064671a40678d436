"""Contours of a binary mask in numpy: the four OpenCV calls of the JAX
package's ``fit_octagon`` (``vfloodnet_tpu/pipelines/object_detection.py``,
``cv2.findContours`` with ``RETR_EXTERNAL`` and ``CHAIN_APPROX_SIMPLE``,
``cv2.contourArea``, ``cv2.arcLength`` closed, ``cv2.approxPolyDP``
closed), which the card's machine cannot call: it has no cv2.

- :func:`find_external_contours` is Suzuki and Abe's border following as
  OpenCV runs it: the image framed by a row and column of zeros, a raster
  scan that starts an outer border at a 0 -> 1 step unless the last border
  pixel met on the row lies on an outer border (so nothing inside a hole
  of another component is followed), borders followed from their start
  pixel with the 8-neighbour search of OpenCV's ``icvFetchContour`` and
  its marks (a pixel whose right neighbour is background gets a negative
  mark), and ``CHAIN_APPROX_SIMPLE``: a point wherever the chain code
  changes. Contours come out in the order OpenCV lists them, the last
  found first.
- :func:`contour_area`, :func:`arc_length`: the shoelace sum in double
  from float coordinates; segment lengths in float, summed in double.
- :func:`approx_poly_dp`: OpenCV's Douglas-Peucker for closed curves. Its
  start point is not the contour's first point: three rounds of "the
  farthest point from the current start" pick two far-apart points, and
  the recursion splits the closed curve there; a last pass drops points on
  nearly straight runs. Another start gives another polygon. A piece is
  split at its point farthest from the chord as a segment (OpenCV 5.0.0:
  beyond an end the distance is to that end), kept if within ``eps``.
"""

from __future__ import annotations

from typing import List

import numpy as np

# chain code -> (dx, dy); 0 is right, counting counter-clockwise on screen
_DX = (1, 1, 0, -1, -1, -1, 0, 1)
_DY = (0, -1, -1, -1, 0, 1, 1, 1)


def _fetch_contour(img: np.ndarray, y0: int, x0: int) -> List[tuple]:
    """Follow the outer border that starts at (y0, x0) of the int8 image
    (1 = unvisited foreground), marking it as OpenCV does; returns the
    CHAIN_APPROX_SIMPLE points (x, y) in the framed image's coordinates."""
    nbd = 2
    neg = nbd - 128                     # (nbd | -128) as int8

    def val(y, x, s):
        return img[y + _DY[s], x + _DX[s]]

    s_end = s = 4
    while True:
        s = (s - 1) & 7
        if val(y0, x0, s) != 0 or s == s_end:
            break
    if s == s_end:                      # a single pixel
        img[y0, x0] = neg
        return [(x0, y0)]
    y1, x1 = y0 + _DY[s], x0 + _DX[s]
    y3, x3 = y0, x0
    prev_s = s ^ 4
    pts = []
    px, py = x0, y0
    while True:
        s_end = s
        while True:
            s += 1
            y4, x4 = y3 + _DY[s & 7], x3 + _DX[s & 7]
            if img[y4, x4] != 0:
                break
        s &= 7
        if (s - 1) % (1 << 32) < s_end:  # the right neighbour is background
            img[y3, x3] = neg
        elif img[y3, x3] == 1:
            img[y3, x3] = nbd
        if s != prev_s:
            pts.append((px, py))
            prev_s = s
        px += _DX[s]
        py += _DY[s]
        if (y4, x4) == (y0, x0) and (y3, x3) == (y1, x1):
            break
        y3, x3 = y4, x4
        s = (s + 4) & 7
    return pts


def find_external_contours(mask: np.ndarray) -> List[np.ndarray]:
    """Outer contours of the nonzero pixels of a 2-D mask, as
    ``cv2.findContours(mask, RETR_EXTERNAL, CHAIN_APPROX_SIMPLE)`` gives
    them: a list of int32 [K, 1, 2] (x, y) arrays."""
    nz = np.nonzero(mask)
    if nz[0].size == 0:
        return []
    # crop to the foreground's box (everything outside is background) and
    # frame it with zeros, as OpenCV frames the image
    top, left = int(nz[0].min()), int(nz[1].min())
    bottom, right = int(nz[0].max()) + 1, int(nz[1].max()) + 1
    img = np.zeros((bottom - top + 2, right - left + 2), np.int8)
    img[1:-1, 1:-1] = mask[top:bottom, left:right] != 0
    height, width = img.shape
    found = []
    for y in range(1, height - 1):
        row = img[y]
        x, prev, lnbd_x = 1, 0, 0
        while x < width:
            step = np.flatnonzero(row[x:] != prev)
            if step.size == 0:
                break
            x += int(step[0])
            p = int(row[x])
            # an outer border starts at 0 -> 1, unless the last border pixel
            # of the row (lnbd) lies on an outer border, i.e. we are inside
            # a component whose hole this is
            if prev == 0 and p == 1 and not row[lnbd_x] > 0:
                pts = _fetch_contour(img, y, x)
                found.append(np.array(pts, np.int32).reshape(-1, 1, 2)
                             + np.array([left - 1, top - 1], np.int32))
                # OpenCV resumes after the start pixel with lnbd unchanged
                prev = int(row[x])
                x += 1
                continue
            prev = p
            if prev & -2:               # a marked border pixel
                lnbd_x = x
            x += 1
    return found[::-1]


def contour_area(cnt: np.ndarray) -> float:
    """``cv2.contourArea`` (unoriented) of integer points [K, 1, 2]."""
    pts = cnt.reshape(-1, 2).astype(np.float64)
    x, y = pts[:, 0], pts[:, 1]
    # integer terms, exact in double in any order
    return abs(float(np.sum(np.roll(x, 1) * y - np.roll(y, 1) * x)) * 0.5)


def arc_length(cnt: np.ndarray) -> float:
    """``cv2.arcLength(cnt, True)`` of integer points [K, 1, 2]."""
    pts = cnt.reshape(-1, 2).astype(np.float32)
    d = pts - np.roll(pts, 1, axis=0)
    seg = np.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]).astype(np.float32)
    total = 0.0
    for v in seg:
        total += float(v)
    return total


def _segment_dist2(pt, a, b) -> float:
    """Squared distance from ``pt`` to the segment a-b (to a, when a == b)."""
    dx, dy = b[0] - a[0], b[1] - a[1]
    px, py = pt[0] - a[0], pt[1] - a[1]
    t = px * dx + py * dy
    len2 = dx * dx + dy * dy
    if t <= 0:
        return float(px * px + py * py)
    if t >= len2:
        qx, qy = pt[0] - b[0], pt[1] - b[1]
        return float(qx * qx + qy * qy)
    cross = float(py * dx - px * dy)
    return cross * cross / len2


def approx_poly_dp(cnt: np.ndarray, eps: float) -> np.ndarray:
    """``cv2.approxPolyDP(cnt, eps, True)`` of integer points [K, 1, 2] ->
    int32 [M, 1, 2]."""
    src = [(int(x), int(y)) for x, y in cnt.reshape(-1, 2)]
    count = len(src)
    if count == 0:
        return np.zeros((0, 1, 2), np.int32)
    eps2 = eps * eps
    dst = []
    stack = []
    # 1. two roughly farthest points
    pos = 0
    right_start = 0
    le_eps = False
    start = src[0]
    for _ in range(3):
        max_dist = 0.0
        pos = (pos + right_start) % count
        start = src[pos]
        pos = (pos + 1) % count
        for j in range(1, count):
            pt = src[pos]
            pos = (pos + 1) % count
            dx, dy = pt[0] - start[0], pt[1] - start[1]
            dist = float(dx * dx + dy * dy)
            if dist > max_dist:
                max_dist = dist
                right_start = j
        le_eps = max_dist <= eps2
    # 2. the stack
    if not le_eps:
        slice_start = pos % count
        right = (right_start + slice_start) % count
        stack.append((right, slice_start))
        stack.append((slice_start, right))
    else:
        dst.append(start)
    # 3. recursion
    while stack:
        s0, s1 = stack.pop()
        end = src[s1]
        pos = s0
        start = src[pos]
        pos = (pos + 1) % count
        if pos != s1:
            max_dist = 0.0
            split = s0
            while pos != s1:
                pt = src[pos]
                pos = (pos + 1) % count
                dist = _segment_dist2(pt, start, end)
                if dist > max_dist:
                    max_dist = dist
                    split = (pos + count - 1) % count
            le_eps = max_dist <= eps2
        else:
            le_eps = True
            start = src[s0]
        if le_eps:
            dst.append(start)
        else:
            stack.append((split, s1))
            stack.append((s0, split))
    # 4. drop points on nearly straight runs
    count = new_count = len(dst)
    pos = count - 1
    start = dst[pos]
    pos = (pos + 1) % count
    wpos = pos
    pt = dst[pos]
    pos = (pos + 1) % count
    i = 0
    while i < count and new_count > 2:
        end = dst[pos]
        pos = (pos + 1) % count
        dx, dy = end[0] - start[0], end[1] - start[1]
        dist = abs((pt[0] - start[0]) * dy - (pt[1] - start[1]) * dx)
        inner = (pt[0] - start[0]) * (end[0] - pt[0]) + \
            (pt[1] - start[1]) * (end[1] - pt[1])
        if dist * dist <= 0.5 * eps2 * (dx * dx + dy * dy) and dx != 0 \
                and dy != 0 and inner >= 0:
            new_count -= 1
            dst[wpos] = start = end
            wpos = (wpos + 1) % count
            pt = dst[pos]
            pos = (pos + 1) % count
            i += 2
            continue
        dst[wpos] = start = pt
        wpos = (wpos + 1) % count
        pt = end
        i += 1
    return np.array(dst[:new_count], np.int32).reshape(-1, 1, 2)
