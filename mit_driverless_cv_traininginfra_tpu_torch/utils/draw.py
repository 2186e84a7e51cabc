"""The drawing primitives of the visualisations, in numpy, on (H, W, C)
or (H, W) uint8 arrays in place: what OpenCV's and PIL's calls in the JAX
package's ``utils/vis.py`` and CLIs draw, so a machine without either
draws the same marks.

- :func:`cv2_circle_filled`: ``cv2.circle(img, c, r, color, -1)``
  (OpenCV's integer midpoint circle, one span a row), bit for bit.
- :func:`cv2_rectangle2`: ``cv2.rectangle(img, p0, p1, color, 2)`` of
  integer corners: each side a 3-pixel band, the corners cut, bit for bit.
- :func:`cv2_line2`: ``cv2.line(img, p0, p1, color, 2)``: OpenCV's thick
  line (a 4-corner polygon in 16-bit fixed point filled by scanline, its
  outline drawn by the fixed-point line walker, a radius-1 disc at each
  end). Lines inside the image match; where OpenCV clips a polygon edge
  at the border first, a pixel or two may differ.
- :func:`pil_rectangle`: ``ImageDraw.rectangle(box, outline=color,
  width=w)``, the box's corners cast to int as PIL's C code casts them,
  bit for bit.
- :func:`pil_dot`: ``ImageDraw.ellipse((x−2, y−2, x+2, y+2), fill=color)``:
  the box cast to int is 3 or 4 pixels a side, and PIL fills it but its
  four corners, bit for bit.
"""

from __future__ import annotations

import math

import numpy as np

_SHIFT = 16
_ONE = 1 << _SHIFT


def _color(img: np.ndarray, color):
    c = np.asarray(color, np.float64)
    return (c.reshape(-1)[:img.shape[2]] if img.ndim == 3 else c.reshape(-1)[0]).astype(
        img.dtype)


def _hline(img, x0: int, x1: int, y: int, c) -> None:
    """Fill row ``y`` from ``x0`` to ``x1`` inclusive, clipped."""
    h, w = img.shape[:2]
    if 0 <= y < h:
        x0, x1 = max(x0, 0), min(x1, w - 1)
        if x0 <= x1:
            img[y, x0:x1 + 1] = c


def _point(img, x: int, y: int, c) -> None:
    h, w = img.shape[:2]
    if 0 <= x < w and 0 <= y < h:
        img[y, x] = c


def _circle(img, cx: int, cy: int, radius: int, c) -> None:
    """OpenCV's ``Circle`` with ``fill``: the midpoint walk, two spans a
    step on each side."""
    h, w = img.shape[:2]
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        y11, y12, y21, y22 = cy - dy, cy + dy, cy - dx, cy + dx
        x11, x12, x21, x22 = cx - dx, cx + dx, cx - dy, cx + dy
        if x11 < w and x12 >= 0 and y21 < h and y22 >= 0:
            for y in (y11, y12):
                _hline(img, x11, x12, y, c)
            if x21 < w and x22 >= 0:
                for y in (y21, y22):
                    _hline(img, x21, x22, y, c)
        dy += 1
        err += plus
        plus += 2
        mask = (1 if err <= 0 else 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def cv2_circle_filled(img: np.ndarray, center, radius: int, color) -> np.ndarray:
    """``cv2.circle(img, center, radius, color, -1)`` (8-connected, no
    shift)."""
    _circle(img, int(center[0]), int(center[1]), int(radius), _color(img, color))
    return img


def cv2_rectangle2(img: np.ndarray, p0, p1, color) -> np.ndarray:
    """``cv2.rectangle(img, p0, p1, color, 2)`` of integer corners: the
    rows within 1 of a horizontal side between the sides' x, and the
    columns within 1 of a vertical side between the sides' y."""
    c = _color(img, color)
    x0, x1 = sorted((int(p0[0]), int(p1[0])))
    y0, y1 = sorted((int(p0[1]), int(p1[1])))
    for y in range(y0 - 1, y0 + 2):
        _hline(img, x0, x1, y, c)
    for y in range(y1 - 1, y1 + 2):
        _hline(img, x0, x1, y, c)
    for y in range(y0, y1 + 1):
        _hline(img, x0 - 1, x0 + 1, y, c)
        _hline(img, x1 - 1, x1 + 1, y, c)
    return img


def _tdiv(a: int, b: int) -> int:
    """C's integer division (towards zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _line_fixed(img, p1, p2, c) -> None:
    """OpenCV's ``Line2``: an 8-connected line between 16-bit fixed-point
    points, stepping one pixel along the longer axis."""
    (x1, y1), (x2, y2) = p1, p2
    dx, dy = x2 - x1, y2 - y1
    if abs(dx) > abs(dy):
        if dx < 0:
            x1, y1, x2, y2, dy = x2, y2, x1, y1, -dy
        y_step = _tdiv(dy << _SHIFT, abs(dx) | 1)
        ecount = (x2 - x1) >> _SHIFT
        _point(img, (x2 + (_ONE >> 1)) >> _SHIFT, (y2 + (_ONE >> 1)) >> _SHIFT, c)
        x, y = (x1 + (_ONE >> 1)) >> _SHIFT, y1 + (_ONE >> 1)
        for _ in range(ecount + 1):
            _point(img, x, y >> _SHIFT, c)
            x += 1
            y += y_step
    else:
        if dy < 0:
            x1, y1, x2, y2, dx = x2, y2, x1, y1, -dx
        x_step = _tdiv(dx << _SHIFT, abs(dy) | 1)
        ecount = (y2 - y1) >> _SHIFT
        _point(img, (x2 + (_ONE >> 1)) >> _SHIFT, (y2 + (_ONE >> 1)) >> _SHIFT, c)
        x, y = x1 + (_ONE >> 1), (y1 + (_ONE >> 1)) >> _SHIFT
        for _ in range(ecount + 1):
            _point(img, x >> _SHIFT, y, c)
            x += x_step
            y += 1


def _fill_convex(img, v, c) -> None:
    """OpenCV's ``FillConvexPoly`` of 16-bit fixed-point vertices (8-connected):
    the outline by :func:`_line_fixed`, then one span a row between the two
    edges walked down from the top vertex."""
    h, w = img.shape[:2]
    n = len(v)
    delta = _ONE >> 1
    p0 = v[-1]
    imin = min(range(n), key=lambda i: (v[i][1], i))
    for p in v:
        _line_fixed(img, p0, p, c)
        p0 = p
    xs, ys = [p[0] for p in v], [p[1] for p in v]
    xmin, xmax = (min(xs) + delta) >> _SHIFT, (max(xs) + delta) >> _SHIFT
    ymin, ymax = (min(ys) + delta) >> _SHIFT, (max(ys) + delta) >> _SHIFT
    if xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edges = [dict(idx=imin, di=1, x=-_ONE, dx=0, ye=ymin),
             dict(idx=imin, di=n - 1, x=-_ONE, dx=0, ye=ymin)]
    remaining = n
    y = ymin
    while True:
        for e in edges:
            if y >= e["ye"]:
                idx0 = e["idx"]
                idx = (idx0 + e["di"]) % n
                while remaining > 0:
                    remaining -= 1
                    ty = (v[idx][1] + delta) >> _SHIFT
                    if ty > y:
                        xs_, xe_ = v[idx0][0], v[idx][0]
                        e.update(ye=ty, x=xs_, idx=idx,
                                 dx=_tdiv((xe_ - xs_) * 2 + (ty - y), 2 * (ty - y)))
                        break
                    idx0, idx = idx, (idx + e["di"]) % n
                else:
                    remaining -= 1
        if remaining < 0:
            break
        if y >= 0:
            left, right = sorted(edges, key=lambda e: e["x"])
            _hline(img, (left["x"] + delta) >> _SHIFT, (right["x"] + delta) >> _SHIFT, y, c)
        for e in edges:
            e["x"] += e["dx"]
        y += 1
        if y > ymax:
            break


def cv2_line2(img: np.ndarray, p0, p1, color) -> np.ndarray:
    """``cv2.line(img, p0, p1, color, 2)`` of integer points."""
    c = _color(img, color)
    (x0, y0), (x1, y1) = (int(p0[0]) << _SHIFT, int(p0[1]) << _SHIFT), \
        (int(p1[0]) << _SHIFT, int(p1[1]) << _SHIFT)
    fdx, fdy = (x0 - x1) / _ONE, (y1 - y0) / _ONE
    r = fdx * fdx + fdy * fdy
    if abs(r) > 2.220446049250313e-16:
        r = _ONE / math.sqrt(r)  # half the thickness of 2, in fixed point
        dpx, dpy = round(fdy * r), round(fdx * r)  # cvRound: half to even
        _fill_convex(img, [(x0 + dpx, y0 + dpy), (x0 - dpx, y0 - dpy),
                           (x1 - dpx, y1 - dpy), (x1 + dpx, y1 + dpy)], c)
    for x, y in ((x0, y0), (x1, y1)):
        _circle(img, (x + (_ONE >> 1)) >> _SHIFT, (y + (_ONE >> 1)) >> _SHIFT, 1, c)
    return img


def pil_rectangle(img: np.ndarray, box, color, width: int = 1) -> np.ndarray:
    """``ImageDraw.rectangle(box, outline=color, width=width)``: the corners
    cast to int (towards zero); ``width`` rows at the top and bottom
    across, then the sides' columns between them."""
    c = _color(img, color)
    x0, y0, x1, y1 = (int(float(v)) for v in box)
    if x1 < x0 or y1 < y0:
        raise ValueError("x1 must be greater than or equal to x0, and y1 than y0")
    for i in range(width):
        _hline(img, x0, x1, y0 + i, c)
        _hline(img, x0, x1, y1 - i, c)
        ya, yb = y0 + width, y1 - width + 1
        step = 1 if yb >= ya else -1
        for k in range(abs(yb - ya)):
            _point(img, x1 - i, ya + k * step, c)
            _point(img, x0 + i, ya + k * step, c)
    return img


def pil_dot(img: np.ndarray, x: float, y: float, color) -> np.ndarray:
    """``ImageDraw.ellipse((x − 2, y − 2, x + 2, y + 2), fill=color)``: the
    box's corners cast to int (towards zero), so 3 or 4 pixels a side;
    PIL fills such a box but its four corner pixels."""
    c = _color(img, color)
    x0, y0, x1, y1 = int(x - 2), int(y - 2), int(x + 2), int(y + 2)
    for yy in range(y0, y1 + 1):
        edge = yy in (y0, y1)
        _hline(img, x0 + edge, x1 - edge, yy, c)
    return img
