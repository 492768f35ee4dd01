"""Conditional-metrics preprocessing: each real image's garment part images
and radius-disc pose heatmap (counterpart of `pasta_gan_tpu/data/parts.py`;
reference `training/dataset.py:279-420`, `ImageFolderDataset`).

The person image is split into head / top / pant / palm part images by its
parsing labels (the palm refined by the arm rectangles from the keypoints,
`data/masks.py:get_hand_mask` / `get_palm_mask`), and each valid OpenPose
keypoint gives an 18-channel binary disc heatmap of radius `sigma`; both
are center square-padded to the larger image side.  Host numpy, NHWC,
without PIL: images decode through `data/image_io.py` and resize with its
LANCZOS, which equals Pillow's.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np

from .image_io import read_image, read_rgb, resize
from .masks import get_hand_mask, get_palm_mask

# LIP parsing label groups (reference dataset.py:297-300)
HEAD_PART_LABELS = (2, 13)
TOP_PART_LABELS = (5, 6, 7, 11)
PANT_PART_LABELS = (8, 9, 12, 18, 19)
LEFT_HAND_LABEL = 14
RIGHT_HAND_LABEL = 15


def square_pad(x: np.ndarray, value: float = 0.0) -> np.ndarray:
    """Center-pad [H, W, ...] to [S, S, ...] with S = max(H, W) (reference dataset.py:315-330)."""
    h, w = x.shape[:2]
    if h > w:
        left = (h - w) // 2
        pad = [(0, 0), (left, h - w - left)] + [(0, 0)] * (x.ndim - 2)
    elif w > h:
        top = (w - h) // 2
        pad = [(top, w - h - top), (0, 0)] + [(0, 0)] * (x.ndim - 2)
    else:
        return x
    return np.pad(x, pad, mode="constant", constant_values=value)


def build_part_masks(parsing: np.ndarray, keypoints: np.ndarray) -> Dict[str, np.ndarray]:
    """head / top / pant / palm binary masks [S, S, 1] float32 from an
    unpadded parsing map: label groups for head, top and pant; the palm is
    the hand labels minus the keypoints' arm rectangles; each computed at
    the native size, then square-padded (reference dataset.py:279-348)."""
    if parsing.ndim == 2:
        parsing = parsing[..., None]
    parsing = parsing[..., :1]

    def group(labels):
        m = np.zeros(parsing.shape, np.float32)
        for label in labels:
            m += (parsing == label).astype(np.float32)
        return m

    H, W = parsing.shape[:2]
    l_up, l_bot = get_hand_mask(keypoints[[5, 6, 7], :], H, W)
    r_up, r_bot = get_hand_mask(keypoints[[2, 3, 4], :], H, W)
    l_palm = get_palm_mask((parsing == LEFT_HAND_LABEL).astype(np.float32), l_up, l_bot)
    r_palm = get_palm_mask((parsing == RIGHT_HAND_LABEL).astype(np.float32), r_up, r_bot)
    masks = (("head", group(HEAD_PART_LABELS)), ("top", group(TOP_PART_LABELS)), ("pant", group(PANT_PART_LABELS)),
             ("palm", l_palm + r_palm))
    return {name: (square_pad(m) > 0).astype(np.float32) for name, m in masks}


def build_part_images(person_img: np.ndarray, parsing: np.ndarray,
                      keypoints: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(head, top, pant, palm) images [S, S, C]: the square-padded person
    image times each padded mask (reference dataset.py:336-346)."""
    masks = build_part_masks(parsing, keypoints)
    return tuple(person_img * masks[k] for k in ("head", "top", "pant", "palm"))


def pose_disc_heatmap(keypoints: np.ndarray, img_size: Tuple[int, int], sigma: float = 8) -> np.ndarray:
    """Binary radius-disc heatmap [S, S, K] uint8 (reference `cords_to_map`,
    dataset.py:384-410): channel k is 1 inside the open disc of radius
    `sigma` around keypoint k; an invalid keypoint (flag -1) gives an empty
    channel; square-padded."""
    h, w = img_size
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    out = np.zeros((h, w, keypoints.shape[0]), np.uint8)
    for i, pt in enumerate(keypoints):
        if pt[2] == -1:
            continue
        out[..., i] = ((xs - pt[0]) ** 2 + (ys - pt[1]) ** 2) < sigma**2
    return square_pad(out)


def sanitize_openpose_keypoints(raw: np.ndarray) -> np.ndarray:
    """OpenPose triplets -> [K, 3] with invalid points flagged -1: a
    coordinate <= 0 or a confidence < 0.01 (reference dataset.py:412-420)."""
    kps = np.asarray(raw, np.float32).reshape(-1, 3).copy()
    invalid = (kps[:, 0] <= 0) | (kps[:, 1] <= 0) | (kps[:, 2] < 0.01)
    kps[invalid, 2] = -1
    return kps


def _lanczos(a: np.ndarray, size: int) -> np.ndarray:
    """`PIL.Image.fromarray(uint8(a)).resize((size, size), LANCZOS)` as float32."""
    return resize(np.asarray(a, np.uint8), (size, size), "lanczos").astype(np.float32)


class PartsFolderDataset:
    """Real images with their conditional part images and pose heatmaps
    (reference `ImageFolderDataset`, dataset.py:168-420).

    The images are every .png / .jpg / .jpeg under `root` but the
    `*_label.png` and `*_mask.png` files; each image's parsing map is
    `<stem>_label.png` beside it (or under `root/parsing/`) and its OpenPose
    keypoints `<stem>_keypoints.json` (or under `root/keypoints/`).  An item
    is a dict: `image` (square-padded uint8 [S, S, 3]); with keypoints,
    `keypoints` and `pose_heatmap`; with keypoints and parsing, `head_img`,
    `top_img`, `pant_img` and `palm_img` (float32).  With `resolution`, the
    image and the part images are resized by LANCZOS, and the heatmap is
    drawn anew at that size from the rescaled keypoints, its padding zeroed
    (index subsampling could skip a whole disc)."""

    def __init__(self, root: str, resolution: Optional[int] = None, sigma: int = 8):
        self.root, self.resolution, self.sigma = root, resolution, sigma
        exts = (".png", ".jpg", ".jpeg")
        self.fnames = sorted(
            os.path.join(r, f) for r, _, files in os.walk(root) for f in files
            if f.lower().endswith(exts) and not f.lower().endswith(("_label.png", "_mask.png")))
        if not self.fnames:
            raise FileNotFoundError(f"no images under {root}")

    def __len__(self):
        return len(self.fnames)

    def _sibling(self, fname: str, suffix: str, subdir: str) -> Optional[str]:
        cand = os.path.splitext(fname)[0] + suffix
        if os.path.exists(cand):
            return cand
        rel = os.path.relpath(fname, self.root)
        cand = os.path.join(self.root, subdir, os.path.splitext(rel)[0] + suffix)
        return cand if os.path.exists(cand) else None

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        fname = self.fnames[idx]
        img = read_rgb(fname)
        item: Dict[str, np.ndarray] = {}
        parsing_path = self._sibling(fname, "_label.png", "parsing")
        kps_path = self._sibling(fname, "_keypoints.json", "keypoints")
        kps = None
        if kps_path is not None:
            with open(kps_path) as f:
                data = json.load(f)
            kps = sanitize_openpose_keypoints(np.asarray(data["people"][0]["pose_keypoints_2d"], np.float32))
            item["pose_heatmap"] = pose_disc_heatmap(kps, img.shape[:2], self.sigma)
            item["keypoints"] = kps

        padded = square_pad(img.astype(np.float32))
        if parsing_path is not None and kps is not None:
            parsing = np.asarray(read_image(parsing_path), np.uint8)
            if parsing.ndim == 3:
                parsing = parsing[..., 0]
            head, top, pant, palm = build_part_images(padded, parsing, kps)
            item.update(head_img=head, top_img=top, pant_img=pant, palm_img=palm)

        if self.resolution is not None and padded.shape[0] != self.resolution:
            S, res = padded.shape[0], self.resolution
            padded = _lanczos(padded, res)
            for k in ("head_img", "top_img", "pant_img", "palm_img"):
                if k in item:
                    item[k] = _lanczos(item[k], res)
            if "pose_heatmap" in item:
                # discs drawn at the target size from the rescaled keypoints (the offsets replay
                # square_pad's centering; sigma scales with the canvas)
                h0, w0 = img.shape[:2]
                scale = res / S
                kp = kps.copy()
                valid = kp[:, 2] != -1
                kp[valid, 0] = (kp[valid, 0] + (S - w0) // 2) * scale
                kp[valid, 1] = (kp[valid, 1] + (S - h0) // 2) * scale
                hm = pose_disc_heatmap(kp, (res, res), max(self.sigma * scale, 1.0))
                # the native map clips its discs at the unpadded image: zero the padding
                y0, x0 = int(round((S - h0) // 2 * scale)), int(round((S - w0) // 2 * scale))
                y1, x1 = int(round(((S - h0) // 2 + h0) * scale)), int(round(((S - w0) // 2 + w0) * scale))
                keep = np.zeros_like(hm)
                keep[y0:y1, x0:x1] = hm[y0:y1, x0:x1]
                item["pose_heatmap"] = keep
        item["image"] = padded.astype(np.uint8)
        return item
