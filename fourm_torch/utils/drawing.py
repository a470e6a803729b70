"""Raster drawing without cv2 or Pillow, for utils/decoding.py's
visualizations (the machine with the card has neither library).

  * `cv_line`, `cv_circle`, `cv_rectangle`: cv2.line, cv2.circle and
    cv2.rectangle (LINE_8, shift 0) of cv2 5.0.0 on a uint8 (H, W) or
    (H, W, C) image, in place, pixel for pixel (held to cv2 by
    tests/test_torch_drawing.py): a 1-pixel line is the LineIterator walk
    (data/transforms.py:_line8, clipped by clipLine); a thicker one is
    clipped to the image grown by its thickness, then drawing.cpp's
    ThickLine, a 16.16 fixed-point quad (FillConvexPoly, its edges by
    Line2) with round caps (Circle of radius thickness / 2); a circle of
    thickness 1 or filled is Circle's midpoint walk; a rectangle its four
    edges.
  * `pil_rectangle`: Pillow's ImageDraw.rectangle(xy, outline=, width=)
    outline (Draw.c's ImagingDrawRectangle: `width` nested frames, the
    coordinates truncated to integers).
  * `draw_text`: a label in a built-in 3 x 5 pixel font, one pixel between
    characters (lower case, digits, space and - . _ :; upper case drawn as
    lower case, other characters as a box). It stands in for Pillow's
    default font, whose glyphs the port does not carry.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np

from ..data.transforms import XY_ONE, XY_SHIFT, _clip_line, _line8


def _put(img: np.ndarray, x: int, y: int, color) -> None:
    if 0 <= x < img.shape[1] and 0 <= y < img.shape[0]:
        img[y, x] = color


def _hline(img: np.ndarray, y: int, x1: int, x2: int, color) -> None:
    img[y, x1:x2 + 1] = color


def _line2(img: np.ndarray, p1, p2, color) -> None:
    """drawing.cpp Line2: a 16.16 fixed-point line, clipped to the image."""
    h, w = img.shape[:2]
    ok, (x1, y1), (x2, y2) = _clip_line(w << XY_SHIFT, h << XY_SHIFT, p1, p2)
    if not ok:
        return
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            dy = -dy
            x1, x2, y1, y2 = x2, x1, y2, y1
        x_step, y_step = XY_ONE, _cdiv(dy << XY_SHIFT, ax | 1)
        ecount = (x2 - x1) >> XY_SHIFT
    else:
        if dy < 0:
            dx = -dx
            x1, x2, y1, y2 = x2, x1, y2, y1
        x_step, y_step = _cdiv(dx << XY_SHIFT, ay | 1), XY_ONE
        ecount = (y2 - y1) >> XY_SHIFT
    x1 += XY_ONE >> 1
    y1 += XY_ONE >> 1
    _put(img, (x2 + (XY_ONE >> 1)) >> XY_SHIFT, (y2 + (XY_ONE >> 1)) >> XY_SHIFT, color)
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


def _cdiv(a: int, b: int) -> int:
    """C integer division (truncation toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def _fill_convex_poly(img: np.ndarray, v: Sequence[Tuple[int, int]], color) -> None:
    """drawing.cpp FillConvexPoly at shift XY_SHIFT, LINE_8: the outline by
    Line2, then rows filled between the two edges walked from the top vertex."""
    h, w = img.shape[:2]
    npts = len(v)
    delta = XY_ONE >> 1
    p0 = v[-1]
    xs_, ys_ = [p[0] for p in v], [p[1] for p in v]
    imin = int(np.argmin(ys_))
    for p in v:
        _line2(img, p0, p, color)
        p0 = p
    xmin, xmax = (min(xs_) + delta) >> XY_SHIFT, (max(xs_) + delta) >> XY_SHIFT
    ymin, ymax = (min(ys_) + delta) >> XY_SHIFT, (max(ys_) + delta) >> XY_SHIFT
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edges = [dict(idx=imin, di=1, x=-XY_ONE, dx=0, ye=ymin),
             dict(idx=imin, di=npts - 1, x=-XY_ONE, dx=0, ye=ymin)]
    left_edges = npts
    y = ymin
    while True:
        for e in edges:
            if y >= e["ye"]:
                idx0, di = e["idx"], e["di"]
                idx = (idx0 + di) % npts
                while left_edges > 0:
                    left_edges -= 1
                    ty = (v[idx][1] + delta) >> XY_SHIFT
                    if ty > y:
                        xs, xe = v[idx0][0], v[idx][0]
                        e["ye"] = ty
                        e["dx"] = _cdiv((xe - xs) * 2 + (ty - y), 2 * (ty - y))
                        e["x"] = xs
                        e["idx"] = idx
                        break
                    idx0 = idx
                    idx = (idx + di) % npts
                else:
                    left_edges -= 1
        if left_edges < 0:
            break
        if y >= 0:
            a, b = (edges[1], edges[0]) if edges[0]["x"] > edges[1]["x"] else (edges[0], edges[1])
            xx1, xx2 = (a["x"] + delta) >> XY_SHIFT, (b["x"] + delta) >> XY_SHIFT
            if xx2 >= 0 and xx1 < w:
                _hline(img, y, max(xx1, 0), min(xx2, w - 1), color)
        for e in edges:
            e["x"] += e["dx"]
        y += 1
        if y > ymax:
            break


def _circle(img: np.ndarray, center: Tuple[int, int], radius: int, color, fill: bool) -> None:
    """drawing.cpp Circle: the midpoint walk, rows filled or its 8 points."""
    h, w = img.shape[:2]
    cx, cy = center
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    inside = radius <= cx < w - radius and radius <= cy < h - radius
    while dx >= dy:
        y11, y12, y21, y22 = cy - dy, cy + dy, cy - dx, cy + dx
        x11, x12, x21, x22 = cx - dx, cx + dx, cx - dy, cx + dy
        if inside:
            for yy, xa, xb in ((y11, x11, x12), (y12, x11, x12), (y21, x21, x22),
                               (y22, x21, x22)):
                if fill:
                    _hline(img, yy, xa, xb, color)
                else:
                    img[yy, xa] = color
                    img[yy, xb] = color
        elif x11 < w and x12 >= 0 and y21 < h and y22 >= 0:
            if fill:
                x11, x12 = max(x11, 0), min(x12, w - 1)
            for yy in (y11, y12):
                if 0 <= yy < h:
                    if fill:
                        _hline(img, yy, x11, x12, color)
                    else:
                        for xx in (x11, x12):
                            if 0 <= xx < w:
                                img[yy, xx] = color
            if x21 < w and x22 >= 0:
                if fill:
                    x21, x22 = max(x21, 0), min(x22, w - 1)
                for yy in (y21, y22):
                    if 0 <= yy < h:
                        if fill:
                            _hline(img, yy, x21, x22, color)
                        else:
                            for xx in (x21, x22):
                                if 0 <= xx < w:
                                    img[yy, xx] = color
        dy += 1
        err += plus
        plus += 2
        mask = -1 if err > 0 else 0
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def _thick_line(img, p0, p1, color, thickness: int, flags: int) -> None:
    """drawing.cpp ThickLine (LINE_8, shift 0): points in 16.16 fixed point."""
    p0 = (p0[0] << XY_SHIFT, p0[1] << XY_SHIFT)
    p1 = (p1[0] << XY_SHIFT, p1[1] << XY_SHIFT)
    if thickness <= 1:
        _line8(img, ((p0[0] + (XY_ONE >> 1)) >> XY_SHIFT, (p0[1] + (XY_ONE >> 1)) >> XY_SHIFT),
               ((p1[0] + (XY_ONE >> 1)) >> XY_SHIFT, (p1[1] + (XY_ONE >> 1)) >> XY_SHIFT), color)
        return
    dx = (p0[0] - p1[0]) / XY_ONE
    dy = (p1[1] - p0[1]) / XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    thick = thickness << (XY_SHIFT - 1)
    if abs(r) > np.finfo(np.float64).eps:
        r = (thick + odd * XY_ONE * 0.5) / math.sqrt(r)
        dpx, dpy = _round(dy * r), _round(dx * r)
        _fill_convex_poly(img, [(p0[0] + dpx, p0[1] + dpy), (p0[0] - dpx, p0[1] - dpy),
                                (p1[0] - dpx, p1[1] - dpy), (p1[0] + dpx, p1[1] + dpy)], color)
    for i in range(2):
        if flags & (i + 1):
            center = ((p0[0] + (XY_ONE >> 1)) >> XY_SHIFT, (p0[1] + (XY_ONE >> 1)) >> XY_SHIFT)
            _circle(img, center, (thick + (XY_ONE >> 1)) >> XY_SHIFT, color, True)
        p0 = p1


def _round(x: float) -> int:
    """cvRound: round half to even (lrint)."""
    return int(np.rint(x))


def _color(img: np.ndarray, color):
    if np.isscalar(color):
        return color
    return color[0] if img.ndim == 2 else np.asarray(color[:img.shape[2]], img.dtype)


def cv_line(img: np.ndarray, p0, p1, color, thickness: int = 1) -> np.ndarray:
    """A line wider than 1 is first clipped to the image grown by its
    thickness on every side, as cv2 5.0.0 clips it (caps at the clipped
    ends)."""
    p0, p1 = tuple(int(v) for v in p0), tuple(int(v) for v in p1)
    if thickness > 1:
        t = thickness
        h, w = img.shape[:2]
        ok, p0, p1 = _clip_line(w + 2 * t, h + 2 * t, (p0[0] + t, p0[1] + t),
                                (p1[0] + t, p1[1] + t))
        if not ok:
            return img
        p0, p1 = (p0[0] - t, p0[1] - t), (p1[0] - t, p1[1] - t)
    _thick_line(img, p0, p1, _color(img, color), thickness, 3)
    return img


def cv_circle(img: np.ndarray, center, radius: int, color, thickness: int = 1) -> np.ndarray:
    """thickness 1 (the outline) or negative (filled); thicker outlines
    (cv2's EllipseEx) are not ported."""
    if thickness > 1:
        raise NotImplementedError("cv_circle draws thickness 1 or filled circles")
    _circle(img, (int(center[0]), int(center[1])), int(radius), _color(img, color), thickness < 0)
    return img


def cv_rectangle(img: np.ndarray, p1, p2, color, thickness: int = 1) -> np.ndarray:
    """The outline (thickness >= 1, cv2's PolyLine of the four corners)."""
    (x1, y1), (x2, y2) = (int(v) for v in p1), (int(v) for v in p2)
    pts = [(x1, y1), (x2, y1), (x2, y2), (x1, y2)]
    c = _color(img, color)
    prev = pts[-1]
    for p in pts:
        _thick_line(img, prev, p, c, thickness, 2)
        prev = p
    return img


def pil_rectangle(img: np.ndarray, xy, color, width: int = 1) -> np.ndarray:
    """ImageDraw.rectangle(xy, outline=color, width=width) on (H, W, C)."""
    x0, y0, x1, y1 = (int(v) for v in xy)
    h, w = img.shape[:2]
    c = _color(img, color)

    def hline(y, xa, xb):
        if 0 <= y < h and xa < w and xb >= 0:
            img[y, max(xa, 0):min(xb, w - 1) + 1] = c

    for i in range(max(width, 1)):
        hline(y0 + i, x0, x1)
        hline(y1 - i, x0, x1)
        ya, yb = y0 + width, y1 - width + 1  # Pillow's line: from ya, stopping before yb
        for x in (x1 - i, x0 + i):
            if 0 <= x < w:
                for y in range(ya, yb, 1 if yb >= ya else -1):
                    if 0 <= y < h:
                        img[y, x] = c
    return img


_FONT = {  # 3 x 5 glyphs, rows top to bottom, bits left to right
    "a": "010101111101101", "b": "110101110101110", "c": "011100100100011",
    "d": "110101101101110", "e": "111100110100111", "f": "111100110100100",
    "g": "011100101101011", "h": "101101111101101", "i": "111010010010111",
    "j": "001001001101010", "k": "101101110101101", "l": "100100100100111",
    "m": "101111111101101", "n": "110101101101101", "o": "010101101101010",
    "p": "110101110100100", "q": "010101101110011", "r": "110101110101101",
    "s": "011100010001110", "t": "111010010010010", "u": "101101101101111",
    "v": "101101101101010", "w": "101101111111101", "x": "101101010101101",
    "y": "101101010010010", "z": "111001010100111", "0": "111101101101111",
    "1": "010110010010111", "2": "110001010100111", "3": "110001010001110",
    "4": "101101111001001", "5": "111100110001110", "6": "011100111101111",
    "7": "111001010010010", "8": "111101111101111", "9": "111101111001110",
    " ": "000000000000000", "-": "000000111000000", ".": "000000000000010",
    "_": "000000000000111", ":": "000010000010000",
}
_BOX = "111101101101111"


def draw_text(img: np.ndarray, xy, text: str, color) -> np.ndarray:
    """`text` in the 3 x 5 font with its top-left corner at xy (clipped)."""
    x0, y0 = int(xy[0]), int(xy[1])
    h, w = img.shape[:2]
    c = _color(img, color)
    for k, ch in enumerate(text.lower()):
        bits = _FONT.get(ch, _BOX)
        for r in range(5):
            for col in range(3):
                x, y = x0 + 4 * k + col, y0 + r
                if bits[3 * r + col] == "1" and 0 <= x < w and 0 <= y < h:
                    img[y, x] = c
    return img
