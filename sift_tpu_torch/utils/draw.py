"""Drawing primitives for visual artifacts (keypoints.png / matches.png).

The JAX package's ``utils/draw.py`` for the port.  Host-side rebuild of the
reference's rasterizers:
  - draw_point (filled square, src/image.cpp:245-263)
  - draw_line (Bresenham, src/image.cpp:272-296)
  - draw_circle (midpoint circle, src/image.cpp:304-328)
  - draw_keypoints (src/sift.cpp:821-844)
  - draw_matches (src/sift.cpp:850-876)

Unlike the reference, drawing is NOT a side effect of detection
(src/sift.cpp:766-768 saves keypoints.png inside the detect API); callers
compose these explicitly.  Numpy on the host: visualization is not a
device concern.  The native C++ rasterizer (csrc/, ``utils/native``) draws
when it builds; the loops here are the reference it is tested against.
"""

from __future__ import annotations

import math

import numpy as np

from sift_tpu_torch.utils import native

# Color palette (src/image_io.hh:11-20)
BLACK = 0x000000
WHITE = 0xFFFFFF
RED = 0xFF0000
GREEN = 0x00FF00
BLUE = 0x0000FF
YELLOW = 0xFFFF00
CYAN = 0x00FFFF
MAGENTA = 0xFF00FF

_KP_COLORS = [RED, GREEN, BLUE, YELLOW, MAGENTA, CYAN, BLACK]


def _set_rgb(img: np.ndarray, x: int, y: int, color: int) -> None:
    img[y, x, 0] = (color & 0xFF0000) >> 16
    img[y, x, 1] = (color & 0x00FF00) >> 8
    img[y, x, 2] = color & 0x0000FF


def draw_point(img: np.ndarray, x: int, y: int, size: int = 1, color: int = WHITE):
    h, w = img.shape[:2]
    # C++ -size/2 truncates toward zero (src/image.cpp:246), unlike Python's
    # floor division: size=1 covers exactly one pixel.
    lo = -(size // 2)
    for i in range(lo, size // 2 + 1):
        if not 0 <= x + i < w:
            continue
        for j in range(lo, size // 2 + 1):
            if not 0 <= y + j < h:
                continue
            if img.ndim == 2:
                img[y + j, x + i] = 255
            else:
                _set_rgb(img, x + i, y + j, color)


def draw_line(img, x1, y1, x2, y2, color=WHITE, thickness=1):
    """Bresenham line (src/image.cpp:272-296)."""
    x1, y1, x2, y2 = int(x1), int(y1), int(x2), int(y2)
    dx, dy = abs(x2 - x1), abs(y2 - y1)
    sx = 1 if x1 < x2 else -1
    sy = 1 if y1 < y2 else -1
    err = dx - dy
    while True:
        draw_point(img, x1, y1, thickness, color)
        if x1 == x2 and y1 == y2:
            break
        e2 = 2 * err
        if e2 > -dy:
            err -= dy
            x1 += sx
        if e2 < dx:
            err += dx
            y1 += sy


def draw_circle(img, x, y, radius, color=WHITE, thickness=1):
    """Midpoint circle (src/image.cpp:304-328)."""
    x, y, radius = int(x), int(y), int(radius)
    x0, y0, err = radius, 0, 0
    while x0 >= y0:
        for px, py in (
            (x + x0, y + y0), (x + y0, y + x0), (x - y0, y + x0), (x - x0, y + y0),
            (x - x0, y - y0), (x - y0, y - x0), (x + y0, y - x0), (x + x0, y - y0),
        ):
            draw_point(img, px, py, thickness, color)
        if err <= 0:
            y0 += 1
            err += 2 * y0 + 1
        if err > 0:
            x0 -= 1
            err -= 2 * x0 + 1


def draw_keypoints(img: np.ndarray, kps: dict, scales_count: float) -> np.ndarray:
    """Scale-colored circles + orientation rays (src/sift.cpp:821-844).

    ``kps``: the valid lanes of one image (``Keypoints.dense()``).  Returns
    an RGB copy.
    """
    out = np.ascontiguousarray(img.astype(np.float64))
    if out.ndim == 2:
        out = np.repeat(out[:, :, None], 3, axis=2)

    if native.available():
        res = native.draw_keypoints_native(
            out.astype(np.float32), kps, scales_count
        )
        if res is not None:
            return res.astype(np.float64)

    max_radius, min_radius = 110.0, 5.0
    for x, y, layer, pori in zip(kps["x"], kps["y"], kps["layer"], kps["pori"]):
        radius = int(
            min_radius
            * math.exp(layer / (scales_count - 1) * math.log(max_radius / min_radius))
        )
        color = _KP_COLORS[int(layer) % len(_KP_COLORS)]
        draw_circle(out, x, y, radius, color)
        x2 = int(x + radius * math.cos(pori))
        y2 = int(y + radius * math.sin(pori))
        draw_line(out, int(x), int(y), x2, y2, color)
    return out


def draw_matches(img_a: np.ndarray, img_b: np.ndarray, pairs) -> np.ndarray:
    """Side-by-side concat + one line per match (src/sift.cpp:850-876).

    ``pairs``: iterable of ((x1, y1), (x2, y2)) in each image's coordinates.
    """
    def to_rgb(im):
        im = np.asarray(im, np.float64)
        if im.ndim == 2:
            return np.repeat(im[:, :, None], 3, axis=2)
        if im.shape[2] == 1:
            return np.repeat(im, 3, axis=2)
        return im

    a, b = to_rgb(img_a), to_rgb(img_b)
    h = max(a.shape[0], b.shape[0])
    out = np.zeros((h, a.shape[1] + b.shape[1], 3))
    out[: a.shape[0], : a.shape[1]] = a
    out[: b.shape[0], a.shape[1] :] = b

    pairs = list(pairs)
    if native.available() and pairs:
        p1 = np.asarray([p[0] for p in pairs], np.float64)
        p2 = np.asarray([p[1] for p in pairs], np.float64)
        res = native.draw_match_lines_native(
            out.astype(np.float32), p1, p2, a.shape[1]
        )
        if res is not None:
            return res.astype(np.float64)

    for (x1, y1), (x2, y2) in pairs:
        draw_line(out, int(x1), int(y1), a.shape[1] + int(x2), int(y2))
    return out
