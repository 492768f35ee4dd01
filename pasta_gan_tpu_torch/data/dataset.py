"""Host samples and the device-side try-on batch.

Counterpart of `pasta_gan_tpu/data/dataset.py`: host code builds per-sample
numpy dicts (image, stickman, keypoints, parsing masks); `prepare_tryon_batch`
moves a collated batch to the device and runs the patch routing there.

This slice serves the synthetic fixture only: decoding the real dataset's
JPEG/PNG files (`load_sample`) waits for a later slice.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from .. import resolve_device
from . import masks as masks_mod
from . import stickman
from .warp import route_patches_transfer_batch, transfer_warp_inputs


def pad_to_square(img: np.ndarray, value: int) -> tuple[np.ndarray, int]:
    """White-pad 256x192 -> 256x256. Returns (padded, left_padding)."""
    h, w = img.shape[:2]
    left = (h - w) // 2
    right = h - w - left
    if img.ndim == 2:
        img = img[..., None]
    out = np.pad(img, ((0, 0), (left, right), (0, 0)), constant_values=value)
    return out, left


class SyntheticUvitonDataset:
    """Deterministic synthetic person fixture: plausible keypoints and simple
    parsing geometry (the JAX package's fixture, numpy drawing branches)."""

    BASE_KPS = {
        0: (96, 40), 1: (96, 70), 2: (70, 72), 3: (60, 105), 4: (56, 140),
        5: (122, 72), 6: (132, 105), 7: (136, 140), 8: (78, 140), 9: (74, 190),
        10: (72, 235), 11: (114, 140), 12: (118, 190), 13: (120, 235),
        14: (90, 34), 15: (102, 34), 16: (84, 38), 17: (108, 38),
    }

    def __init__(self, num_samples: int = 8, resolution: int = 256, seed: int = 0):
        self.n = num_samples
        self.res = resolution
        self.seed = seed

    def __len__(self):
        return self.n

    def _keypoints(self, rng) -> np.ndarray:
        kps = np.zeros((18, 3), np.float32)
        for i, (x, y) in self.BASE_KPS.items():
            kps[i] = (x + rng.normal(0, 4), y + rng.normal(0, 4), 0.9)
        return kps

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(self.seed * 100003 + idx)
        kps = self._keypoints(rng)
        parsing = np.zeros((256, 192), np.uint8)

        def rect(x0, y0, x1, y1, label):
            parsing[max(0, int(y0)) : int(y1), max(0, int(x0)) : int(x1)] = label

        # head circle (13), torso garment (5), pants (9), arms (14/15),
        # legs (16/17), shoes (18/19)
        cx, cy = int(kps[0][0]), int(kps[0][1])
        yy, xx = np.ogrid[:256, :192]
        parsing[(yy - cy) ** 2 + (xx - cx) ** 2 < 18**2] = 13
        rect(kps[2][0], kps[2][1], kps[5][0], kps[8][1], 5)
        rect(kps[8][0] - 8, kps[8][1], kps[11][0] + 8, kps[9][1] + 20, 9)
        rect(kps[3][0] - 6, kps[3][1] - 10, kps[3][0] + 6, kps[4][1], 15)
        rect(kps[6][0] - 6, kps[6][1] - 10, kps[6][0] + 6, kps[7][1], 14)
        rect(kps[9][0] - 7, kps[9][1] + 20, kps[9][0] + 7, kps[10][1], 16)
        rect(kps[12][0] - 7, kps[12][1] + 20, kps[12][0] + 7, kps[13][1], 17)
        rect(kps[10][0] - 8, kps[10][1], kps[10][0] + 8, 255, 18)
        rect(kps[13][0] - 8, kps[13][1], kps[13][0] + 8, 255, 19)

        colors = rng.integers(40, 215, (20, 3))
        image = np.full((256, 192, 3), 255, np.uint8)
        for label in range(1, 20):
            image[parsing == label] = colors[label % 20]
        image = np.clip(image.astype(np.int32) + rng.integers(-12, 12, image.shape), 0, 255).astype(np.uint8)

        image_p, left = pad_to_square(image, 255)
        parsing_p, _ = pad_to_square(parsing, 0)
        pose = stickman.draw_pose_from_cords(kps, (256, 192))
        pose_p, _ = pad_to_square(pose, 0)

        kps_padded = kps.copy()
        kps_padded[:, 0] += left
        m = masks_mod.build_sample_masks(kps_padded, parsing_p)

        return dict(
            image=image_p,
            pose=pose_p,
            keypoints=kps,
            retain_mask=m["retain"].astype(np.uint8),
            upper_mask=m["upper"].astype(np.uint8),
            lower_mask=m["lower"].astype(np.uint8),
            lower_test_mask=m["lower_test"].astype(np.uint8),
            gt_parsing=m["gt_parsing"][..., 0].astype(np.uint8),
            acgpn_mask=np.zeros((256, 256, 1), np.uint8),
            left_padding=np.int32(left),
        )


def collate(samples: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def _tryon_sources(person, garment, dev):
    def f32(d, k):
        return torch.as_tensor(d[k], device=dev).float()

    p_img = f32(person, "image") / 255.0
    g_img = f32(garment, "image") / 255.0
    p_lower_mask = f32(person, "lower_test_mask" if "lower_test_mask" in person else "lower_mask")
    g_upper_mask = f32(garment, "upper_mask")
    routing_args = (
        g_img * g_upper_mask, p_img * p_lower_mask, g_upper_mask, p_lower_mask,
        f32(garment, "keypoints"), f32(person, "keypoints"),
    )
    return p_img, f32(person, "pose"), f32(person, "retain_mask"), routing_args


def tryon_warp_inputs(person, garment, box_factor: int = 2, device="cuda") -> dict:
    """The routing kernels' operands for a collated try-on batch (what
    `prepare_tryon_batch` feeds them)."""
    _, _, _, routing_args = _tryon_sources(person, garment, resolve_device(device))
    return transfer_warp_inputs(*routing_args, box_factor=box_factor)


def prepare_tryon_batch(person, garment, box_factor: int = 2, device="cuda") -> Dict[str, torch.Tensor]:
    """Unpaired try-on batch: garment patches re-projected into the person's
    pose, the person keeping only its retain regions.  `person`/`garment` are
    collated host dicts (numpy or tensors); returns float32 NHWC tensors on
    `device` with the JAX package's keys and shapes."""
    p_img, pose, p_retain, routing_args = _tryon_sources(person, garment, resolve_device(device))
    routed = route_patches_transfer_batch(*routing_args, box_factor=box_factor)
    denorm_upper_mask = (routed.denorm_upper_img.sum(-1, keepdim=True) > 0).float()
    denorm_lower_mask = (routed.denorm_lower_img.sum(-1, keepdim=True) > 0).float()

    p_real = p_img * 2.0 - 1.0
    head = p_retain * p_real - (1.0 - p_retain)
    return {
        "style_input": torch.cat([routed.norm_img, routed.norm_img_lower], dim=-1) * 2.0 - 1.0,
        "retain": head,
        "pose": torch.cat([pose / 127.5 - 1.0, head], dim=-1),
        "denorm_upper_img": routed.denorm_upper_img * 2.0 - 1.0,
        "denorm_lower_img": routed.denorm_lower_img * 2.0 - 1.0,
        "denorm_upper_mask": denorm_upper_mask,
        "denorm_lower_mask": denorm_lower_mask,
        "person_img": p_real,
    }
