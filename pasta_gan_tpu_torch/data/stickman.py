"""Pose stickman rasterization (reference `training/dataset.py:42-50,704-746`).

Counterpart of `pasta_gan_tpu/data/stickman.py` on its default branch: the
limbs are drawn pixel for pixel as `cv2.line(img, p0, p1, color, 2)` draws
them (`_draw_limb`), in numpy and integer arithmetic, without importing cv2.
Drawing ~19 limbs + 18 discs per sample is cheap host work; the expensive
geometry (patch warps) runs on the device in data/warp.py.
"""

from __future__ import annotations

import json
import math
from typing import Optional

import numpy as np

# 19 limbs, 1-based keypoint indices (reference dataset.py:48-50).
LIMB_SEQ = [
    [2, 3], [2, 6], [3, 4], [4, 5], [6, 7], [7, 8], [2, 9], [9, 10],
    [10, 11], [2, 12], [12, 13], [13, 14], [2, 1], [1, 15], [15, 17],
    [1, 16], [16, 18], [3, 17], [6, 18],
]

KPT_COLORS = [
    [255, 0, 0], [255, 85, 0], [255, 170, 0], [255, 255, 0], [170, 255, 0],
    [85, 255, 0], [0, 255, 0], [0, 255, 85], [0, 255, 170], [0, 255, 255],
    [0, 170, 255], [0, 85, 255], [0, 0, 255], [85, 0, 255], [170, 0, 255],
    [255, 0, 255], [255, 0, 170], [255, 0, 85], [255, 0, 0],
]

MIN_CONF = 0.1


XY_SHIFT = 16  # cv2's fixed-point drawing precision
XY_ONE = 1 << XY_SHIFT
LIMB_THICKNESS = 2


def _div0(a: int, b: int) -> int:
    """C's integer division (rounds toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """cv2.clipLine against [0, w) x [0, h): (inside, x1, y1, x2, y2)."""
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1, c1 = a, 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2, c2 = a, 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _edge_points(h: int, w: int, p1, p2, ys: list, xs: list) -> None:
    """Append the pixels of cv2's fixed-point `Line2` (8-connected) from p1 to
    p2, clipped to the frame, to ys / xs."""
    inside, x1, y1, x2, y2 = _clip_line(w << XY_SHIFT, h << XY_SHIFT, *p1, *p2)
    if not inside:
        return
    half = XY_ONE >> 1
    dx, dy = x2 - x1, y2 - y1
    pts = []
    if abs(dx) > abs(dy):
        if dx < 0:
            x1, y1, x2, y2, dy = x2, y2, x1, y1, -dy
        step = _div0(dy << XY_SHIFT, abs(dx) | 1)
        x, y = (x1 + half) >> XY_SHIFT, y1 + half
        for k in range(((x2 - x1) >> XY_SHIFT) + 1):
            pts.append((x + k, (y + k * step) >> XY_SHIFT))
    else:
        if dy < 0:
            x1, y1, x2, y2, dx = x2, y2, x1, y1, -dx
        step = _div0(dx << XY_SHIFT, abs(dy) | 1)
        x, y = x1 + half, (y1 + half) >> XY_SHIFT
        for k in range(((y2 - y1) >> XY_SHIFT) + 1):
            pts.append(((x + k * step) >> XY_SHIFT, y + k))
    pts.append(((x2 + half) >> XY_SHIFT, (y2 + half) >> XY_SHIFT))  # the end point after the swap, as cv2
    for x, y in pts:
        if 0 <= x < w and 0 <= y < h:
            xs.append(x)
            ys.append(y)


def _fill_convex(img: np.ndarray, v, color) -> None:
    """cv2's `FillConvexPoly` (8-connected, XY_SHIFT fixed point): the edges
    (`_edge_points`), then the rows between the two edge walks."""
    h, w = img.shape[:2]
    npts, half = len(v), XY_ONE >> 1
    ys, xs = [], []
    for p0, p in zip([v[-1]] + list(v[:-1]), v):
        _edge_points(h, w, p0, p, ys, xs)
    img[ys, xs] = color
    xs, ys = [p[0] for p in v], [p[1] for p in v]
    imin = ys.index(min(ys))
    xmin, xmax = (min(xs) + half) >> XY_SHIFT, (max(xs) + half) >> XY_SHIFT
    ymin, ymax = (min(ys) + half) >> XY_SHIFT, (max(ys) + half) >> XY_SHIFT
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    # per edge walk: [vertex index, direction, x, dx, last row]
    edges = [[imin, 1, -XY_ONE, 0, ymin], [imin, npts - 1, -XY_ONE, 0, ymin]]
    left_to_visit, y = npts, ymin
    while True:
        for e in edges:
            if y < e[4]:
                continue
            idx0 = e[0]
            idx = (idx0 + e[1]) % npts
            while True:
                left_to_visit -= 1
                if left_to_visit < 0:
                    break
                ty = (v[idx][1] + half) >> XY_SHIFT
                if ty > y:
                    xs0, xe = v[idx0][0], v[idx][0]
                    e[:] = [idx, e[1], xs0, _div0((xe - xs0) * 2 + (ty - y), 2 * (ty - y)), ty]
                    break
                idx0, idx = idx, (idx + e[1]) % npts
        if left_to_visit < 0:
            break
        if y >= 0:
            xa, xb = sorted((edges[0][2], edges[1][2]))
            x1, x2 = (xa + half) >> XY_SHIFT, (xb + half) >> XY_SHIFT
            if x2 >= 0 and x1 < w:
                img[y, max(x1, 0) : min(x2, w - 1) + 1] = color
        edges[0][2] += edges[0][3]
        edges[1][2] += edges[1][3]
        y += 1
        if y > ymax:
            break


def _draw_limb(img: np.ndarray, p0, p1, color) -> None:
    """`cv2.line(img, p0, p1, color, 2)` (8-connected) on an HxWx3 uint8
    image: the endpoints clipped to the frame grown by the thickness, a
    2-pixel-wide body as a convex 4-gon in 16-bit fixed point, and a filled
    radius-1 diamond (cv2's 4-point ellipse) at each end."""
    h, w = img.shape[:2]
    t = LIMB_THICKNESS
    inside, x0, y0, x1, y1 = _clip_line(w + 2 * t, h + 2 * t, p0[0] + t, p0[1] + t, p1[0] + t, p1[1] + t)
    if not inside:
        return
    x0, y0, x1, y1 = ((c - t) << XY_SHIFT for c in (x0, y0, x1, y1))
    half_width = t << (XY_SHIFT - 1)
    dx, dy = (x0 - x1) / XY_ONE, (y1 - y0) / XY_ONE
    r = dx * dx + dy * dy
    if abs(r) > np.finfo(np.float64).eps:
        r = half_width / math.sqrt(r)
        ox, oy = round(dy * r), round(dx * r)  # half-to-even, as cvRound
        _fill_convex(img, [(x0 + ox, y0 + oy), (x0 - ox, y0 - oy), (x1 - ox, y1 - oy), (x1 + ox, y1 + oy)], color)
    for cx, cy in ((x0, y0), (x1, y1)):
        _fill_convex(img, [(cx + half_width, cy), (cx, cy + half_width), (cx - half_width, cy),
                           (cx, cy - half_width), (cx + half_width, cy)], color)


def _disc_coords(cx, cy, radius, shape):
    """Pixels (row, col) within `radius` of (cx, cy) inside the frame (the JAX
    package's full-frame test, evaluated on the disc's bounding box)."""
    r0, c0 = max(cx - radius, 0), max(cy - radius, 0)
    ys, xs = np.ogrid[r0 : min(cx + radius + 1, shape[0]), c0 : min(cy + radius + 1, shape[1])]
    rows, cols = np.nonzero((ys - cx) ** 2 + (xs - cy) ** 2 <= radius**2)
    return rows + r0, cols + c0


def draw_pose_from_cords(
    pose_joints: np.ndarray,  # [18, 3] (x, y, conf)
    img_size: tuple[int, int],  # (H, W)
    radius: int = 2,
    draw_joints: bool = True,
) -> np.ndarray:
    """Render the colored stickman; matches the reference's drawing order
    (limbs as 2px lines, then keypoint discs; note the reference swaps x/y
    when drawing — reproduced here)."""
    colors = np.zeros(img_size + (3,), dtype=np.uint8)
    if draw_joints:
        for i, (f1, t1) in enumerate(LIMB_SEQ):
            f, t = f1 - 1, t1 - 1
            if pose_joints[f][2] < MIN_CONF or pose_joints[t][2] < MIN_CONF:
                continue
            fy, fx = int(pose_joints[f][0]), int(pose_joints[f][1])
            ty, tx = int(pose_joints[t][0]), int(pose_joints[t][1])
            _draw_limb(colors, (fy, fx), (ty, tx), KPT_COLORS[i])
    for i, joint in enumerate(pose_joints):
        if joint[2] < MIN_CONF:
            continue
        x, y = int(joint[1]), int(joint[0])
        xx, yy = _disc_coords(x, y, radius, img_size)
        colors[xx, yy] = KPT_COLORS[i]
    return colors


def load_keypoints(keypoints_path: str) -> np.ndarray:
    """OpenPose JSON -> [18, 3]; zeros when no person detected
    (reference `dataset.py:738-746`)."""
    with open(keypoints_path, "r") as f:
        data = json.load(f)
    if len(data.get("people", [])) == 0:
        return np.zeros((18, 3), np.float32)
    return np.asarray(data["people"][0]["pose_keypoints_2d"], np.float32).reshape(-1, 3)


def cords_to_map(
    cords: np.ndarray, img_size: tuple[int, int], sigma: float = 6.0
) -> np.ndarray:
    """Gaussian keypoint heatmaps [H, W, 18] (reference `dataset.py:585-615`)."""
    H, W = img_size
    result = np.zeros((H, W, cords.shape[0]), np.float32)
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    for i, (x, y, score) in enumerate(cords):
        if score < MIN_CONF:
            continue
        result[..., i] = np.exp(-((xx - int(x)) ** 2 + (yy - int(y)) ** 2) / (2 * sigma**2))
    return result
