"""Pose stickman rasterization (reference `training/dataset.py:42-50,704-746`).

Copy of `pasta_gan_tpu/data/stickman.py` with only its numpy branch (no cv2):
drawing ~19 line segments + 18 discs per sample is cheap host work; the
expensive geometry (patch warps) runs on the device in data/warp.py.
"""

from __future__ import annotations

import json
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


def _draw_line_np(img: np.ndarray, p0, p1, color, thickness=2):
    """Numpy Bresenham-ish thick line fallback."""
    x0, y0 = p0
    x1, y1 = p1
    n = int(max(abs(x1 - x0), abs(y1 - y0), 1)) * 2
    xs = np.linspace(x0, x1, n).round().astype(int)
    ys = np.linspace(y0, y1, n).round().astype(int)
    h, w = img.shape[:2]
    r = thickness // 2
    for dx in range(-r, r + 1):
        for dy in range(-r, r + 1):
            xi = np.clip(xs + dx, 0, w - 1)
            yi = np.clip(ys + dy, 0, h - 1)
            img[yi, xi] = color
    return img


def _disc_coords(cx, cy, radius, shape):
    ys, xs = np.ogrid[: shape[0], : shape[1]]
    mask = (ys - cx) ** 2 + (xs - cy) ** 2 <= radius**2
    return np.nonzero(mask)


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
            _draw_line_np(colors, (fy, fx), (ty, tx), KPT_COLORS[i], 2)
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
