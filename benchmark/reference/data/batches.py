"""The try-on batches of the serving paths, from collated host samples.

A frozen copy of the port's `data/dataset.py` try-on functions
(`collate`, `prepare_tryon_batch`, `prepare_tryon_batch_512` and their
helpers), over this package's routes.  `device` is a torch.device.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from .warp import route_patches_512_batch, route_patches_transfer_batch


def collate(samples: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def _f32(d, k, dev):
    return torch.as_tensor(d[k], device=dev).float()


def _tryon_sources(person, garment, dev):
    """The garment's upper clothes and the person's own lower clothes (the
    256 test path's lower grouping where the sample has it), then the two
    keypoint sets."""
    p_img = _f32(person, "image", dev) / 255.0
    g_img = _f32(garment, "image", dev) / 255.0
    p_lower_mask = _f32(person, "lower_test_mask" if "lower_test_mask" in person else "lower_mask", dev)
    g_upper_mask = _f32(garment, "upper_mask", dev)
    return (g_img * g_upper_mask, p_img * p_lower_mask, g_upper_mask, p_lower_mask,
            _f32(garment, "keypoints", dev), _f32(person, "keypoints", dev))


def _person_conditioning(person, dev):
    """(person image in [-1, 1], retain image, 6-channel pose)."""
    p_real = _f32(person, "image", dev) / 255.0 * 2.0 - 1.0
    p_retain = _f32(person, "retain_mask", dev)
    retain = p_retain * p_real - (1.0 - p_retain)
    return p_real, retain, torch.cat([_f32(person, "pose", dev) / 127.5 - 1.0, retain], dim=-1)


def _tryon_batch(routed, person, dev) -> Dict[str, torch.Tensor]:
    p_real, retain, pose = _person_conditioning(person, dev)
    return {
        "style_input": torch.cat([routed.norm_img, routed.norm_img_lower], dim=-1) * 2.0 - 1.0,
        "retain": retain,
        "pose": pose,
        "denorm_upper_img": routed.denorm_upper_img * 2.0 - 1.0,
        "denorm_lower_img": routed.denorm_lower_img * 2.0 - 1.0,
        "denorm_upper_mask": (routed.denorm_upper_img.sum(-1, keepdim=True) > 0).float(),
        "denorm_lower_mask": (routed.denorm_lower_img.sum(-1, keepdim=True) > 0).float(),
        "person_img": p_real,
    }


def prepare_tryon_batch(person, garment, box_factor: int = 2, device=torch.device("cpu"),
                        denorm: str = "fused") -> Dict[str, torch.Tensor]:
    """Unpaired try-on batch: the garment's patches re-projected into the
    person's pose, the person keeping only its retain regions.  Float32 NHWC."""
    routed = route_patches_transfer_batch(*_tryon_sources(person, garment, device), box_factor=box_factor,
                                          denorm=denorm)
    return _tryon_batch(routed, person, device)


def _region_sources(person, garment, dev):
    out = []
    for d in (person, garment):
        img = _f32(d, "image", dev) / 255.0
        up, lo = _f32(d, "upper_mask", dev), _f32(d, "lower_mask", dev)
        out.append((img * up, img * lo, up, lo))
    return (*out[0], *out[1], _f32(person, "keypoints", dev), _f32(garment, "keypoints", dev))


def prepare_tryon_batch_512(person, garment, change_region: str = "fullbody", box_factor: int = 2,
                            pad_x: float = 96.0, device=torch.device("cpu"), denorm: str = "fused"):
    """The 512x320 region-selectable batch; `pad_x` is the samples' left
    padding (96 at 512x320).  Float32 NHWC."""
    routed = route_patches_512_batch(*_region_sources(person, garment, device), change_region=change_region,
                                     box_factor=box_factor, pad_x=pad_x, denorm=denorm)
    return _tryon_batch(routed, person, device)
