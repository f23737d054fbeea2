"""ROI masks from polygons with cv2.fillPoly's pixel rule (host NumPy).

An even-odd scanline fill between paired edge crossings in 16.16 fixed
point (a row's span is [ceil(x_left), floor(x_right)]), plus the outline
drawn with the 8-connected Bresenham of cv2.line.  The vertices are
truncated to integers first, as the reference script's cast does.
"""

from __future__ import annotations

import numpy as np

_SHIFT = 16
_ONE = 1 << _SHIFT


def _line8(mask, x0, y0, x1, y1):
    """cv2.line(..., LINE_8, thickness=1): walked left to right, the longer
    axis major, err from dmaj - 2 dmin, the minor axis stepping on err < 0."""
    h, w = mask.shape
    dx, dy = x1 - x0, y1 - y0
    if dx < 0:
        x0, y0, dx, dy = x1, y1, -dx, -dy
    sy = 1 if dy >= 0 else -1
    xmaj = abs(dy) <= dx
    dmaj, dmin = (dx, abs(dy)) if xmaj else (abs(dy), dx)
    err = dmaj - 2 * dmin
    x, y = x0, y0
    for _ in range(dmaj + 1):
        if 0 <= y < h and 0 <= x < w:
            mask[y, x] = True
        if err < 0:
            err += 2 * dmaj - 2 * dmin
            x += 1
            y += sy
        else:
            err -= 2 * dmin
            if xmaj:
                x += 1
            else:
                y += sy


def fill_poly(h: int, w: int, polygon) -> np.ndarray:
    """(h, w) bool mask of one polygon [[x, y], ...]."""
    poly = np.asarray(polygon).astype(np.int32)
    mask = np.zeros((h, w), bool)
    n = len(poly)
    if n == 0:
        return mask
    edges = []
    for i in range(n):
        x0, y0 = int(poly[i, 0]), int(poly[i, 1])
        x1, y1 = int(poly[(i + 1) % n, 0]), int(poly[(i + 1) % n, 1])
        _line8(mask, x0, y0, x1, y1)
        if y0 == y1:
            continue
        if y0 < y1:
            yt, yb, xt, num = y0, y1, x0, (x1 - x0) << _SHIFT
        else:
            yt, yb, xt, num = y1, y0, x1, (x0 - x1) << _SHIFT
        edges.append((yt, yb, xt << _SHIFT, int(num / (yb - yt))))
    if not edges:
        return mask
    for y in range(max(min(e[0] for e in edges), 0), min(max(e[1] for e in edges), h)):
        xs = sorted(xt + (y - yt) * d for yt, yb, xt, d in edges if yt <= y < yb)
        for j in range(0, len(xs) - 1, 2):
            lo = max((xs[j] + _ONE - 1) >> _SHIFT, 0)
            hi = min(xs[j + 1] >> _SHIFT, w - 1)
            if lo <= hi:
                mask[y, lo:hi + 1] = True
    return mask
