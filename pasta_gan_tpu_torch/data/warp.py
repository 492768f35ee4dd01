"""Perspective warps and the patch-routing step of the try-on path.

Counterpart of `pasta_gan_tpu/data/warp.py` (the reference's per-sample
`cv2.warpPerspective` calls), with the cv2 semantics kept:

* `warpPerspective(img, M, (w, h))` samples src at M^-1(x, y), bilinearly, at
  integer pixel coordinates;
* norm warps use BORDER_REPLICATE, denorm warps BORDER_CONSTANT(0);
* a denorm pixel is kept only where the warped mask is saturated
  (`== 255` on uint8, here >= 254.5/255);
* parts composite in order, later parts overwriting earlier ones.

On CUDA tensors the NORM warps run as one `norm_warp` kernel launch and the
DENORM + erode + composite as one `composite` launch (ops/warp_kernels.py); on
CPU tensors the same wrappers run their plain PyTorch versions.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops.warp_kernels import (
    MASK_SATURATION_THRESHOLD,
    composite,
    denorm_warp_reference,
    erode_binary,
    norm_warp,
    norm_warp_reference,
)
from ..ops.warp_math import inv3x3
from .geometry import HAND_PARTS, LOWER_PART_START, NUM_PARTS, part_transforms

__all__ = [
    "MASK_SATURATION_THRESHOLD",
    "RoutedPatches",
    "erode_binary",
    "route_patches_transfer_batch",
    "transfer_warp_inputs",
    "warp_perspective",
]


def warp_perspective(img: torch.Tensor, M: torch.Tensor, out_hw, border: str = "constant") -> torch.Tensor:
    """cv2.warpPerspective(img [H, W, C], M [3, 3] src->dst, (w, h)), bilinear."""
    minv = inv3x3(M)[None, None]
    if border == "replicate":
        ones = torch.ones((1, 1), dtype=torch.float32, device=img.device)
        out = norm_warp_reference(img[None], img[None], minv, ones, 1, out_hw)
    elif border == "constant":
        out = denorm_warp_reference(img.permute(2, 0, 1)[None, None], minv, out_hw)
    else:
        raise ValueError(f"border must be 'replicate' or 'constant', got {border!r}")
    return out[0, 0].permute(1, 2, 0)


class RoutedPatches(NamedTuple):
    norm_img: torch.Tensor  # [B, h, w, 30]  10 upper parts x 3ch (part-major)
    norm_img_lower: torch.Tensor  # [B, h, w, 12]  4 lower parts x 3ch
    denorm_upper_img: torch.Tensor  # [B, H, W, 3]
    denorm_lower_img: torch.Tensor  # [B, H, W, 3]
    M_invs: torch.Tensor  # [B, 10, 3, 3]
    denorm_hand_masks: torch.Tensor  # [B, 4, H, W, 1]
    norm_clothes_masks: torch.Tensor  # [B, h, w, 30]
    norm_clothes_masks_lower: torch.Tensor  # [B, h, w, 12]
    valid: torch.Tensor  # [B, 10] bool


def _stack_ch(x: torch.Tensor) -> torch.Tensor:
    """Planar [B, P, C, h, w] -> [B, h, w, P*C] (part-major channels)."""
    B, P, C, h, w = x.shape
    return x.permute(0, 3, 4, 1, 2).reshape(B, h, w, P * C)


def transfer_warp_inputs(
    garment_upper_img: torch.Tensor,  # [B, H, W, 3] garment person's upper clothes, [0, 1]
    person_lower_img: torch.Tensor,  # [B, H, W, 3] target person's own lower clothes
    garment_upper_mask: torch.Tensor,  # [B, H, W, 1]
    person_lower_mask: torch.Tensor,  # [B, H, W, 1]
    garment_keypoints: torch.Tensor,  # [B, 18, 3]
    person_keypoints: torch.Tensor,  # [B, 18, 3] target pose
    box_factor: int = 2,
    img_h: Optional[int] = None,
    pad_x: float = 32.0,
) -> dict:
    """Geometry and kernel operands of the unpaired try-on routing.

    The upper garment normalizes with the garment's M (parts 0-9), the
    person's own lower clothes self-route with the person's M (parts 6-9,
    appended as 10-13), and all 14 patches re-project with the person's
    M_inv.  Masks of parts 0-5 are 5x5-eroded before the composite (the
    reference test path's `cv2.erode`)."""
    H, W = garment_upper_img.shape[1:3]
    h, w = H >> box_factor, W >> box_factor
    L = LOWER_PART_START
    Mg, _, valid_g = part_transforms(
        garment_keypoints, img_h=img_h or H, patch_w=w, patch_h=h, pad_x=pad_x, knee_fallbacks=True
    )
    Mp, Mp_inv, valid_p = part_transforms(
        person_keypoints, img_h=img_h or H, patch_w=w, patch_h=h, pad_x=pad_x, knee_fallbacks=True
    )
    n_parts = NUM_PARTS + (NUM_PARTS - L)
    return dict(
        # norm: image + mask as one 4-channel frame per source, replicate border
        src_u=torch.cat([garment_upper_img, garment_upper_mask[..., :1]], dim=-1).float().contiguous(),
        src_l=torch.cat([person_lower_img, person_lower_mask[..., :1]], dim=-1).float().contiguous(),
        minv_norm=inv3x3(torch.cat([Mg, Mp[:, L:]], dim=1)).contiguous(),
        valid_norm=torch.cat([valid_g, valid_p[:, L:]], dim=1).float().contiguous(),
        n_upper=NUM_PARTS,
        patch_hw=(h, w),
        # denorm + saturate + erode + composite into the person's frame
        minv_denorm=inv3x3(torch.cat([Mp_inv, Mp_inv[:, L:]], dim=1)).contiguous(),
        valid_denorm=torch.cat([valid_p, valid_p[:, L:]], dim=1).float().contiguous(),
        frame_hw=(H, W),
        groups=(0,) * NUM_PARTS + (1,) * (NUM_PARTS - L),
        erode_parts=tuple(p < L for p in range(n_parts)),
        hand_parts=HAND_PARTS,
        M_invs=Mp_inv,
        valid=valid_g,
    )


def route_patches_transfer_batch(*args, **kwargs) -> RoutedPatches:
    """Unpaired try-on routing (arguments of `transfer_warp_inputs`): one
    `norm_warp` and one `composite` call for the whole batch."""
    r = transfer_warp_inputs(*args, **kwargs)
    patches = norm_warp(r["src_u"], r["src_l"], r["minv_norm"], r["valid_norm"], r["n_upper"], r["patch_hw"])
    g_imgs, hands = composite(
        patches, r["minv_denorm"], r["valid_denorm"], r["frame_hw"], r["groups"], r["erode_parts"],
        r["hand_parts"],
    )
    n = r["n_upper"]
    return RoutedPatches(
        norm_img=_stack_ch(patches[:, :n, 0:3]),
        norm_img_lower=_stack_ch(patches[:, n:, 0:3]),
        denorm_upper_img=g_imgs[:, 0].permute(0, 2, 3, 1),
        denorm_lower_img=g_imgs[:, 1].permute(0, 2, 3, 1),
        M_invs=r["M_invs"],
        denorm_hand_masks=hands[..., None],
        norm_clothes_masks=_stack_ch(patches[:, :n, 3:4].expand(-1, -1, 3, -1, -1)),
        norm_clothes_masks_lower=_stack_ch(patches[:, n:, 3:4].expand(-1, -1, 3, -1, -1)),
        valid=r["valid"],
    )
