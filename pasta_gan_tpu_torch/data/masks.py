"""Parsing-label mask builders + palm-mask geometry.

Copy of `pasta_gan_tpu/data/masks.py` with only its numpy branches (no cv2,
no native extension).  Counterpart of the reference `training/dataset.py:538-560` (label groupings) and
`:619-700` (palm mask via rectangle polygons + dilation), with pycocotools
replaced by a numpy polygon fill.

19-label human-parsing groupings of record:
  retain  = shoes(18,19) + head(1,2,4,13) + palm (geometry-derived)
  upper   = 5,6,7        lower = 9,12
  gt_parsing = upper*1 + lower*2 + hands(14,15)*3 + legs(16,17)*4 + neck(10)*5
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

SHOES_LABELS = (18, 19)
HEAD_LABELS = (1, 2, 4, 13)
UPPER_LABELS = (5, 6, 7)
LOWER_LABELS = (9, 12)
# the 256 test path's person lower-clothes grouping adds dresses (label 6),
# reference dataset.py:1117
LOWER_TEST_LABELS = (6, 9, 12)
HANDS_LABELS = (14, 15)
LEGS_LABELS = (16, 17)
NECK_LABEL = 10


def _label_mask(parsing: np.ndarray, labels) -> np.ndarray:
    m = np.zeros_like(parsing, dtype=np.uint8)
    for l in labels:
        m |= (parsing == l).astype(np.uint8)
    return m


def parsing_masks(parsing: np.ndarray) -> dict:
    """parsing: [H, W] or [H, W, 1] int labels. Returns uint8 [H, W, 1] masks."""
    if parsing.ndim == 2:
        parsing = parsing[..., None]
    shoes = _label_mask(parsing, SHOES_LABELS)
    head = _label_mask(parsing, HEAD_LABELS)
    upper = _label_mask(parsing, UPPER_LABELS)
    lower = _label_mask(parsing, LOWER_LABELS)
    lower_test = _label_mask(parsing, LOWER_TEST_LABELS)
    hands = _label_mask(parsing, HANDS_LABELS)
    legs = _label_mask(parsing, LEGS_LABELS)
    neck = _label_mask(parsing, (NECK_LABEL,))
    gt_parsing = (upper * 1 + lower * 2 + hands * 3 + legs * 4 + neck * 5).astype(np.uint8)
    return dict(
        shoes=shoes, head=head, upper=upper, lower=lower, lower_test=lower_test,
        hands=hands, legs=legs, neck=neck, gt_parsing=gt_parsing,
    )


def _fill_polygon(points: np.ndarray, img_h: int, img_w: int) -> np.ndarray:
    """Binary polygon fill [H, W, 1] float32 (replaces pycocotools frPyObjects):
    the JAX package's numpy even-odd scanline branch."""
    mask = np.zeros((img_h, img_w), np.float32)
    ys, xs = np.mgrid[:img_h, :img_w]
    n = len(points)
    inside = np.zeros((img_h, img_w), bool)
    j = n - 1
    for i in range(n):
        xi, yi = points[i]
        xj, yj = points[j]
        cond = ((points[i][1] > ys) != (points[j][1] > ys)) & (
            xs < (xj - xi) * (ys - yi) / (yj - yi + 1e-12) + xi
        )
        inside ^= cond
        j = i
    mask[inside] = 1.0
    return mask[..., None]


def _dilate(mask: np.ndarray, ksize: int) -> np.ndarray:
    """Binary dilation with a ksize x ksize box (cv2.dilate equivalent): the JAX
    package's numpy sliding-window branch."""
    from numpy.lib.stride_tricks import sliding_window_view

    pad = ksize // 2
    m = np.pad(mask[..., 0], pad, mode="constant")
    win = sliding_window_view(m, (ksize, ksize))[: mask.shape[0], : mask.shape[1]]
    return win.max(axis=(-1, -2)).astype(np.float32)[..., None]


def get_rectangle_mask(a, b, c, d, img_h: int, img_w: int) -> np.ndarray:
    """Oriented limb rectangle from two joints (reference `dataset.py:626-650`)."""
    x1, y1 = a + (b - d) / 4, b + (c - a) / 4
    x2, y2 = a - (b - d) / 4, b - (c - a) / 4
    x3, y3 = c + (b - d) / 4, d + (c - a) / 4
    x4, y4 = c - (b - d) / 4, d - (c - a) / 4

    v0 = (c - a, d - b)
    v1 = (x3 - x1, y3 - y1)
    v2 = (x4 - x1, y4 - y1)

    def cos(v, u):
        return (v[0] * u[0] + v[1] * u[1]) / (
            math.sqrt(v[0] ** 2 + v[1] ** 2) * math.sqrt(u[0] ** 2 + u[1] ** 2) + 1e-12
        )

    if cos(v0, v1) < cos(v0, v2):
        pts = [(x1, y1), (x2, y2), (x3, y3), (x4, y4)]
    else:
        pts = [(x1, y1), (x2, y2), (x4, y4), (x3, y3)]
    return _fill_polygon(np.asarray(pts, np.float32), img_h, img_w) * 255.0


def get_hand_mask(hand_keypoints: np.ndarray, img_h: int = 256, img_w: int = 256):
    """(up_mask, bottom_mask) arm rectangles from shoulder/elbow/wrist
    (reference `dataset.py:652-672`)."""
    s_x, s_y, s_c = hand_keypoints[0]
    e_x, e_y, e_c = hand_keypoints[1]
    w_x, w_y, w_c = hand_keypoints[2]

    up_mask = np.ones((img_h, img_w, 1), np.float32)
    bottom_mask = np.ones((img_h, img_w, 1), np.float32)
    if s_c > 0.1 and e_c > 0.1:
        up_mask = get_rectangle_mask(s_x, s_y, e_x, e_y, img_h, img_w)
        up_mask = (_dilate(up_mask, 25) > 0).astype(np.float32)
    if e_c > 0.1 and w_c > 0.1:
        bottom_mask = get_rectangle_mask(e_x, e_y, w_x, w_y, img_h, img_w)
        bottom_mask = (_dilate(bottom_mask, 16) > 0).astype(np.float32)
    return up_mask, bottom_mask


def get_palm_mask(hand_mask, hand_up_mask, hand_bottom_mask) -> np.ndarray:
    """Hand-parsing minus arm rectangles == palm (reference `dataset.py:674-680`)."""
    inter_up = ((hand_mask + hand_up_mask) == 2).astype(np.float32)
    hand_mask = hand_mask - inter_up
    inter_bottom = ((hand_mask + hand_bottom_mask) == 2).astype(np.float32)
    return hand_mask - inter_bottom


def get_palm(keypoints: np.ndarray, parsing: np.ndarray, left_padding: int = 0) -> np.ndarray:
    """Full palm mask (reference `dataset.py:682-700`); parsing already padded."""
    if parsing.ndim == 2:
        parsing = parsing[..., None]
    H, W = parsing.shape[:2]
    left = keypoints[[5, 6, 7], :].copy()
    right = keypoints[[2, 3, 4], :].copy()
    left[:, 0] += left_padding
    right[:, 0] += left_padding

    l_up, l_bot = get_hand_mask(left, H, W)
    r_up, r_bot = get_hand_mask(right, H, W)
    l_hand = (parsing == 14).astype(np.float32)
    r_hand = (parsing == 15).astype(np.float32)
    l_palm = get_palm_mask(l_hand, l_up, l_bot)
    r_palm = get_palm_mask(r_hand, r_up, r_bot)
    return ((l_palm + r_palm) > 0).astype(np.uint8)


def build_sample_masks(keypoints: np.ndarray, parsing: np.ndarray) -> dict:
    """All masks for one padded sample: parsing groups + palm + retain."""
    masks = parsing_masks(parsing)
    palm = get_palm(keypoints, parsing, left_padding=0)
    retain = (masks["shoes"] + palm + masks["head"]).astype(np.uint8)
    masks["palm"] = palm
    masks["retain"] = retain
    return masks
