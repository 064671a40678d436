"""``cv2.line`` and a zero-radius ``cv2.circle`` in numpy, for the
depth canvases (the card's machine has no cv2): OpenCV's thick 8-connected
line, a convex quadrilateral filled by its scan converter in 16-bit fixed
point with 8-connected edges, and a filled disc of radius thickness / 2 at
each end; the circle of radius 0 is such a line of length 0."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


def _tdiv(a: int, b: int) -> int:
    """C's integer division (towards zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _put(img: np.ndarray, x: int, y: int, color) -> None:
    if 0 <= x < img.shape[1] and 0 <= y < img.shape[0]:
        img[y, x] = color


def _hline(img: np.ndarray, y: int, x1: int, x2: int, color) -> None:
    if 0 <= y < img.shape[0]:
        x1, x2 = max(x1, 0), min(x2, img.shape[1] - 1)
        if x1 <= x2:
            img[y, x1:x2 + 1] = color


def _line_fixed(img: np.ndarray, p1: Tuple[int, int], p2: Tuple[int, int],
                color) -> None:
    """An 8-connected line between 16-bit fixed-point points (OpenCV's
    ``Line2``)."""
    (x1, y1), (x2, y2) = p1, p2
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            x1, x2, y1, y2 = x2, x1, y2, y1
            dy = -dy
        x_step, y_step = XY_ONE, _tdiv(dy << XY_SHIFT, ax | 1)
        ecount = (x2 - x1) >> XY_SHIFT
    else:
        if dy < 0:
            x1, x2, y1, y2 = x2, x1, y2, y1
            dx = -dx
        x_step, y_step = _tdiv(dx << XY_SHIFT, ay | 1), XY_ONE
        ecount = (y2 - y1) >> XY_SHIFT
    x1 += XY_ONE >> 1
    y1 += XY_ONE >> 1
    _put(img, (x2 + (XY_ONE >> 1)) >> XY_SHIFT,
         (y2 + (XY_ONE >> 1)) >> XY_SHIFT, color)
    if ax > ay:
        x1 >>= XY_SHIFT
        while ecount >= 0:
            _put(img, x1, y1 >> XY_SHIFT, color)
            x1 += 1
            y1 += y_step
            ecount -= 1
    else:
        y1 >>= XY_SHIFT
        while ecount >= 0:
            _put(img, x1 >> XY_SHIFT, y1, color)
            x1 += x_step
            y1 += 1
            ecount -= 1


def _fill_convex(img: np.ndarray, v: Sequence[Tuple[int, int]],
                 color) -> None:
    """OpenCV's ``FillConvexPoly`` of 16-bit fixed-point vertices,
    8-connected edges included."""
    npts = len(v)
    delta = XY_ONE >> 1
    p0 = v[-1]
    imin = 0
    xmin = xmax = v[0][0]
    ymin = ymax = v[0][1]
    for i, p in enumerate(v):
        if p[1] < ymin:
            ymin, imin = p[1], i
        ymax = max(ymax, p[1])
        xmax = max(xmax, p[0])
        xmin = min(xmin, p[0])
        _line_fixed(img, p0, p, color)
        p0 = p
    xmin, xmax = (xmin + delta) >> XY_SHIFT, (xmax + delta) >> XY_SHIFT
    ymin, ymax = (ymin + delta) >> XY_SHIFT, (ymax + delta) >> XY_SHIFT
    height, width = img.shape[:2]
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= width or ymin >= height:
        return
    ymax = min(ymax, height - 1)
    edges = npts
    e_idx, e_di = [imin, imin], [1, npts - 1]
    e_ye, e_x, e_dx = [ymin, ymin], [-XY_ONE, -XY_ONE], [0, 0]
    y = ymin
    while True:
        for i in range(2):
            if y >= e_ye[i]:
                idx0 = e_idx[i]
                idx = (idx0 + e_di[i]) % npts
                while edges > 0:
                    edges -= 1
                    ty = (v[idx][1] + delta) >> XY_SHIFT
                    if ty > y:
                        xs, xe = v[idx0][0], v[idx][0]
                        e_ye[i] = ty
                        e_dx[i] = _tdiv((xe - xs) * 2 + (ty - y),
                                        2 * (ty - y))
                        e_x[i] = xs
                        e_idx[i] = idx
                        break
                    idx0 = idx
                    idx = (idx + e_di[i]) % npts
                else:
                    edges -= 1
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if e_x[0] > e_x[1] else (0, 1)
            _hline(img, y, (e_x[left] + delta) >> XY_SHIFT,
                   (e_x[right] + delta) >> XY_SHIFT, color)
        e_x[0] += e_dx[0]
        e_x[1] += e_dx[1]
        y += 1
        if y > ymax:
            break


def _disc(img: np.ndarray, cx: int, cy: int, radius: int, color) -> None:
    """OpenCV's filled ``Circle`` (midpoint spans)."""
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        for y, x1, x2 in ((cy - dy, cx - dx, cx + dx),
                          (cy + dy, cx - dx, cx + dx),
                          (cy - dx, cx - dy, cx + dy),
                          (cy + dx, cx - dy, cx + dy)):
            _hline(img, y, x1, x2, color)
        dy += 1
        err += plus
        plus += 2
        mask = (1 if err <= 0 else 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def line(img: np.ndarray, p0, p1, color, thickness: int = 1) -> None:
    """``cv2.line(img, p0, p1, color, thickness)`` (8-connected), in
    place, for thickness > 1."""
    x0, y0 = (int(p0[0]) << XY_SHIFT, int(p0[1]) << XY_SHIFT)
    x1, y1 = (int(p1[0]) << XY_SHIFT, int(p1[1]) << XY_SHIFT)
    color = np.asarray(color, img.dtype)
    dx = float(x0 - x1) / XY_ONE
    dy = float(y1 - y0) / XY_ONE
    r = dx * dx + dy * dy
    half = (thickness << (XY_SHIFT - 1)) + (thickness & 1) * XY_ONE * 0.5
    if abs(r) > np.finfo(np.float64).eps:
        r = half / np.sqrt(r)
        ddx, ddy = int(np.rint(dy * r)), int(np.rint(dx * r))
        _fill_convex(img, [(x0 + ddx, y0 + ddy), (x0 - ddx, y0 - ddy),
                           (x1 - ddx, y1 - ddy), (x1 + ddx, y1 + ddy)],
                     color)
    radius = (int(thickness << (XY_SHIFT - 1)) + (XY_ONE >> 1)) >> XY_SHIFT
    for x, y in ((x0, y0), (x1, y1)):
        _disc(img, (x + (XY_ONE >> 1)) >> XY_SHIFT,
              (y + (XY_ONE >> 1)) >> XY_SHIFT, radius, color)


def dot(img: np.ndarray, center, color, thickness: int) -> None:
    """``cv2.circle(img, center, 0, color, thickness)`` for thickness > 1,
    in place: OpenCV draws a zero-radius circle as a one-point ellipse
    polygon, a thick line from the point to itself, so a disc of radius
    thickness / 2 (rounded) at the point, twice."""
    line(img, center, center, color, thickness)
