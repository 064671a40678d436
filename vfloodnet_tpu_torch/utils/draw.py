"""OpenCV's 8-connected drawing in numpy, for the depth canvases and the
synthetic training scenes (the card's machine has no cv2), pixel for
pixel OpenCV 5.0.0's:

- :func:`line`: ``cv2.line``. One pixel thick, the Bresenham walk of
  ``LineIterator``; thicker, a convex quadrilateral filled by the scan
  converter in 16-bit fixed point with 8-connected edges, and a filled
  disc of radius thickness / 2 at each end. :func:`dot`, a zero-radius
  ``cv2.circle``, is such a line of length 0.
- :func:`polylines`: ``cv2.polylines``, the same segments with a disc at
  the end of each only, so a closed outline's joins are each drawn once.
- :func:`fill_poly`: ``cv2.fillPoly`` of one polygon, by OpenCV's edge
  table (``CollectPolyEdges`` and ``FillEdgeCollection``), not its convex
  scan converter: the two disagree on some edge pixels.
- :func:`fill_rect`: a filled ``cv2.rectangle`` (the convex scan
  converter with integer corners).
- :func:`fill_circle`: a filled ``cv2.circle`` (midpoint spans).

Shapes are drawn in place and must lie inside the image: OpenCV clips a
line that leaves it to the border first, which moves its pixels; here
pixels outside are dropped."""

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


def _bresenham(img: np.ndarray, p1: Tuple[int, int], p2: Tuple[int, int],
               color) -> None:
    """A one-pixel 8-connected line between integer points, walked left
    to right (OpenCV's ``Line``, its ``LineIterator``)."""
    (x1, y1), (x2, y2) = p1, p2
    dx, dy = x2 - x1, y2 - y1
    if dx < 0:
        dx, dy = -dx, -dy
        x1, y1 = x2, y2
    sy = 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err, plus, minus = dx - 2 * dy, 2 * dx, -2 * dy
    x, y = x1, y1
    for _ in range(dx + 1):
        _put(img, x, y, color)
        step = err < 0
        err += minus + (plus if step else 0)
        if vert:
            y += sy
            x += step
        else:
            x += 1
            y += sy if step else 0


def _fill_convex(img: np.ndarray, v: Sequence[Tuple[int, int]],
                 color, shift: int = XY_SHIFT) -> None:
    """OpenCV's ``FillConvexPoly`` of vertices with ``shift`` fractional
    bits, 8-connected edges included (``Line2`` in fixed point, or for
    ``shift`` 0 the integer ``Line``)."""
    npts = len(v)
    delta = (1 << shift) >> 1
    up = XY_SHIFT - shift
    p0 = (v[-1][0] << up, v[-1][1] << up)
    imin = 0
    xmin = xmax = v[0][0]
    ymin = ymax = v[0][1]
    for i, p in enumerate(v):
        if p[1] < ymin:
            ymin, imin = p[1], i
        ymax = max(ymax, p[1])
        xmax = max(xmax, p[0])
        xmin = min(xmin, p[0])
        p = (p[0] << up, p[1] << up)
        if shift == 0:
            _bresenham(img, (p0[0] >> XY_SHIFT, p0[1] >> XY_SHIFT),
                       (p[0] >> XY_SHIFT, p[1] >> XY_SHIFT), color)
        else:
            _line_fixed(img, p0, p, color)
        p0 = p
    xmin, xmax = (xmin + delta) >> shift, (xmax + delta) >> shift
    ymin, ymax = (ymin + delta) >> shift, (ymax + delta) >> shift
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
                    ty = (v[idx][1] + delta) >> shift
                    if ty > y:
                        xs, xe = v[idx0][0] << up, v[idx][0] << up
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
            half = XY_ONE >> 1
            _hline(img, y, (e_x[left] + half) >> XY_SHIFT,
                   (e_x[right] + half) >> XY_SHIFT, color)
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


def _thick_line(img: np.ndarray, p0, p1, color, thickness: int,
                ends: Tuple[bool, bool]) -> None:
    """OpenCV's ``ThickLine`` between integer points: for thickness 1 the
    Bresenham line, else the quadrilateral and a disc at each end that
    ``ends`` names."""
    if thickness <= 1:
        _bresenham(img, (int(p0[0]), int(p0[1])), (int(p1[0]), int(p1[1])),
                   color)
        return
    x0, y0 = (int(p0[0]) << XY_SHIFT, int(p0[1]) << XY_SHIFT)
    x1, y1 = (int(p1[0]) << XY_SHIFT, int(p1[1]) << XY_SHIFT)
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
    for end, (x, y) in zip(ends, ((x0, y0), (x1, y1))):
        if end:
            _disc(img, (x + (XY_ONE >> 1)) >> XY_SHIFT,
                  (y + (XY_ONE >> 1)) >> XY_SHIFT, radius, color)


def line(img: np.ndarray, p0, p1, color, thickness: int = 1) -> None:
    """``cv2.line(img, p0, p1, color, thickness)`` (8-connected), in
    place."""
    _thick_line(img, p0, p1, np.asarray(color, img.dtype), thickness,
                (True, True))


def polylines(img: np.ndarray, pts, closed: bool, color,
              thickness: int = 1) -> None:
    """``cv2.polylines(img, [pts], closed, color, thickness)`` of one
    integer polyline, in place: each segment with a disc at its end only
    (an open polyline's first segment at its start too)."""
    pts = [(int(x), int(y)) for x, y in pts]
    color = np.asarray(color, img.dtype)
    p0 = pts[-1] if closed else pts[0]
    for i in range(0 if closed else 1, len(pts)):
        _thick_line(img, p0, pts[i], color, thickness,
                    (not closed and i == 1, True))
        p0 = pts[i]


def fill_poly(img: np.ndarray, pts, color) -> None:
    """``cv2.fillPoly(img, [pts], color)`` of one integer polygon, in
    place: its 8-connected outline, then the spans between the active
    edges of each row, edge positions in 16-bit fixed point (OpenCV's
    ``CollectPolyEdges`` and ``FillEdgeCollection``)."""
    pts = [(int(x), int(y)) for x, y in pts]
    color = np.asarray(color, img.dtype)
    half = XY_ONE >> 1
    edges = []                          # [y0, y1, x, dx]
    p0 = pts[-1]
    for p1 in pts:
        _bresenham(img, p0, p1, color)
        if p0[1] != p1[1]:
            x0, x1 = (p0[0] << XY_SHIFT) + half, (p1[0] << XY_SHIFT) + half
            dx = _tdiv(x1 - x0, p1[1] - p0[1])
            edges.append([p0[1], p1[1], x0, dx] if p0[1] < p1[1]
                         else [p1[1], p0[1], x1, dx])
        p0 = p1
    if len(edges) < 2:
        return
    height, width = img.shape[:2]
    ends = [e[2] + (e[1] - e[0]) * e[3] for e in edges]
    y_min = min(e[0] for e in edges)
    y_max = max(e[1] for e in edges)
    x_min = min(min(e[2] for e in edges), min(ends))
    x_max = max(max(e[2] for e in edges), max(ends))
    if y_max < 0 or y_min >= height or x_max < 0 or \
            x_min >= (width << XY_SHIFT):
        return
    edges.sort(key=lambda e: (e[0], e[2], e[3]))
    y_max = min(y_max, height)
    active, i = [], 0
    for y in range(edges[0][0], y_max):
        # drop the edges that end here, merge in those that start here
        # before the first active edge not left of them
        merged = []
        for e in active:
            if e[1] == y:
                continue
            while i < len(edges) and edges[i][0] == y and \
                    not e[2] < edges[i][2]:
                merged.append(edges[i])
                i += 1
            merged.append(e)
        while i < len(edges) and edges[i][0] == y:
            merged.append(edges[i])
            i += 1
        for a, b in zip(merged[0::2], merged[1::2]):
            if y >= 0:
                lo, hi = (b, a) if a[2] > b[2] else (a, b)
                # the left end rounds the edge, the right end floors it
                _hline(img, y, lo[2] >> XY_SHIFT, (hi[2] - half) >> XY_SHIFT,
                       color)
            a[2] += a[3]
            b[2] += b[3]
        active = sorted(merged, key=lambda e: e[2])


def fill_rect(img: np.ndarray, p0, p1, color) -> None:
    """``cv2.rectangle(img, p0, p1, color, -1)``, in place."""
    (x0, y0), (x1, y1) = ((int(p0[0]), int(p0[1])),
                          (int(p1[0]), int(p1[1])))
    _fill_convex(img, [(x0, y0), (x1, y0), (x1, y1), (x0, y1)],
                 np.asarray(color, img.dtype), shift=0)


def fill_circle(img: np.ndarray, center, radius: int, color) -> None:
    """``cv2.circle(img, center, radius, color, -1)``, in place."""
    _disc(img, int(center[0]), int(center[1]), int(radius),
          np.asarray(color, img.dtype))


def dot(img: np.ndarray, center, color, thickness: int) -> None:
    """``cv2.circle(img, center, 0, color, thickness)`` for thickness > 1,
    in place: OpenCV draws a zero-radius circle as a one-point ellipse
    polygon, a thick line from the point to itself, so a disc of radius
    thickness / 2 (rounded) at the point, twice."""
    line(img, center, center, color, thickness)




