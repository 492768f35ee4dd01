"""Perspective warps and the patch-routing step of the try-on path.

Counterpart of `pasta_gan_tpu/data/warp.py` (the reference's per-sample
`cv2.warpPerspective` calls), with the cv2 semantics kept:

* `warpPerspective(img, M, (w, h))` samples src at M^-1(x, y), bilinearly, at
  integer pixel coordinates;
* norm warps use BORDER_REPLICATE, denorm warps BORDER_CONSTANT(0);
* a denorm pixel is kept only where the warped mask is saturated
  (`== 255` on uint8, here >= 254.5/255);
* parts composite in order, later parts overwriting earlier ones.

Five routes share the kernels: the unpaired try-on route
(`route_patches_transfer_batch`), the training path's self-routing
(`route_patches_batch`), the snapshot grid's cross-pair route
(`route_patches_mix_batch`), the released-256 (V19) test route
(`route_patches_v19_batch`) and the 512x320 region-selectable route
(`route_patches_512_batch`).  On CUDA tensors the NORM warps run as one
`norm_warp` kernel launch.  The DENORM step takes one of two routes, chosen
by each route's `denorm` argument (the JAX package's
`TUNING.fused_composite`):

* "fused" (the default): denorm + saturate + erode + composite as one
  `composite` launch;
* "separate": the separate-pass pipeline, one `denorm_warp` launch that
  writes every part's full-frame warp, then the threshold, erosion and
  select chain as PyTorch ops (`composite_reference` with `warp=denorm_warp`).

Both give the same routing (the kernels repeat the plain versions' rounded
operations).  On CPU tensors the same wrappers run their plain PyTorch
versions (ops/warp_kernels.py).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops.warp_kernels import (
    MASK_SATURATION_THRESHOLD,
    composite,
    composite_reference,
    denorm_warp,
    denorm_warp_reference,
    erode_binary,
    norm_warp,
)
from ..ops.warp_math import inv3x3
from .geometry import HAND_PARTS, LOWER_PART_START, NUM_PARTS, part_transforms

__all__ = [
    "CHANGE_REGIONS",
    "DENORM_ROUTES",
    "LOWER_PARTS_512",
    "MASK_SATURATION_THRESHOLD",
    "MIX_SWAPS",
    "RoutedPatches",
    "RoutedPatches512",
    "RoutedPatchesV19",
    "erode_binary",
    "mix_warp_inputs",
    "route_patches_512_batch",
    "route_patches_batch",
    "route_patches_mix_batch",
    "route_patches_transfer_batch",
    "route_patches_v19_batch",
    "self_warp_inputs",
    "transfer_warp_inputs",
    "v19_warp_inputs",
    "warp_inputs_512",
    "warp_perspective",
    "warp_perspective_inv",
]

DENORM_ROUTES = ("fused", "separate")


def warp_perspective(img: torch.Tensor, M: torch.Tensor, out_hw, border: str = "constant") -> torch.Tensor:
    """cv2.warpPerspective(img [H, W, C], M [3, 3] src->dst, (w, h)), bilinear."""
    ones = torch.ones((1, 1), dtype=torch.float32, device=img.device)
    out = denorm_warp_reference(img.permute(2, 0, 1)[None, None], inv3x3(M)[None, None], ones, out_hw, border)
    return out[0, 0].permute(1, 2, 0)


def warp_perspective_inv(img: torch.Tensor, Minv: torch.Tensor, out_hw, border: str = "constant") -> torch.Tensor:
    """Warp a batch img [B, C, H, W] with explicit dst->src matrices Minv
    [B, 3, 3] (no inversion), bilinear: the exact warp of the ADA pipe.
    Differentiable (to every order) in img, not in Minv; float32 out."""
    ones = torch.ones((img.shape[0], 1), dtype=torch.float32, device=img.device)
    return denorm_warp_reference(img[:, None], Minv[:, None].detach(), ones, out_hw, border)[:, 0]


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


def _routing_inputs(upper_img, lower_img, upper_mask, lower_mask, M_upper, M_lower, valid_upper, valid_lower,
                    M_inv, valid_denorm, erode_upper: bool, patch_hw,
                    lower_parts=tuple(range(LOWER_PART_START, NUM_PARTS)), erode_all: bool = False,
                    hand_parts=HAND_PARTS) -> dict:
    """Operands of one `norm_warp` + one `composite` launch: the upper source
    normalizes with M_upper (parts 0-9), the lower source with M_lower's
    `lower_parts` (appended as 10, 11, ...), and every patch re-projects with
    M_inv into two composited groups (upper, lower) and the `hand_parts`
    masks.  `erode_upper` erodes the masks of parts 0-5 before the
    composite, `erode_all` those of every part."""
    H, W = upper_img.shape[1:3]
    L = LOWER_PART_START
    LP = list(lower_parts)
    return dict(
        # norm: image + mask as one 4-channel frame per source, replicate border
        src_u=torch.cat([upper_img, upper_mask[..., :1]], dim=-1).float().contiguous(),
        src_l=torch.cat([lower_img, lower_mask[..., :1]], dim=-1).float().contiguous(),
        minv_norm=inv3x3(torch.cat([M_upper, M_lower[:, LP]], dim=1)).contiguous(),
        valid_norm=torch.cat([valid_upper, valid_lower[:, LP]], dim=1).float().contiguous(),
        n_upper=NUM_PARTS,
        patch_hw=patch_hw,
        # denorm + saturate + (erode) + composite into the target frame
        minv_denorm=inv3x3(torch.cat([M_inv, M_inv[:, LP]], dim=1)).contiguous(),
        valid_denorm=torch.cat([valid_denorm, valid_denorm[:, LP]], dim=1).float().contiguous(),
        frame_hw=(H, W),
        groups=(0,) * NUM_PARTS + (1,) * len(LP),
        erode_parts=tuple(erode_all or (erode_upper and p < L) for p in range(NUM_PARTS + len(LP))),
        hand_parts=tuple(hand_parts),
        M_invs=M_inv,
        valid=valid_upper,
    )


def _region_sources(person_upper_img, person_lower_img, person_upper_mask, person_lower_mask,
                    garment_upper_img, garment_lower_img, garment_upper_mask, garment_lower_mask,
                    person_keypoints, garment_keypoints, upper_from_garment: bool, lower_from_garment: bool,
                    box_factor: int, img_h: Optional[int], pad_x: float, knee_fallbacks: bool):
    """The two sources of a cross-pair route, each (image, mask, M, valid)
    from the person (self-routed with the person's M) or the garment
    provider (normalized with the garment's M), and the person's M_inv,
    validity and patch size, for `_routing_inputs`."""
    H = person_upper_img.shape[1]
    h, w = H >> box_factor, person_upper_img.shape[2] >> box_factor
    kw = dict(img_h=img_h or H, patch_w=w, patch_h=h, pad_x=pad_x, knee_fallbacks=knee_fallbacks)
    Mg, _, valid_g = part_transforms(garment_keypoints, **kw)
    Mp, Mp_inv, valid_p = part_transforms(person_keypoints, **kw)
    up = ((garment_upper_img, garment_upper_mask, Mg, valid_g) if upper_from_garment
          else (person_upper_img, person_upper_mask, Mp, valid_p))
    lo = ((garment_lower_img, garment_lower_mask, Mg, valid_g) if lower_from_garment
          else (person_lower_img, person_lower_mask, Mp, valid_p))
    return (up[0], lo[0], up[1], lo[1], up[2], lo[2], up[3], lo[3], Mp_inv, valid_p), (h, w)


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
    Mg, _, valid_g = part_transforms(
        garment_keypoints, img_h=img_h or H, patch_w=w, patch_h=h, pad_x=pad_x, knee_fallbacks=True
    )
    Mp, Mp_inv, valid_p = part_transforms(
        person_keypoints, img_h=img_h or H, patch_w=w, patch_h=h, pad_x=pad_x, knee_fallbacks=True
    )
    return _routing_inputs(garment_upper_img, person_lower_img, garment_upper_mask, person_lower_mask,
                           Mg, Mp, valid_g, valid_p, Mp_inv, valid_p, True, (h, w))


def self_warp_inputs(upper_img, lower_img, upper_mask, lower_mask, keypoints, box_factor: int = 2,
                     img_h: Optional[int] = None, pad_x: float = 32.0) -> dict:
    """Operands of the training path's self-routing: one keypoint set
    normalizes both sources and denormalizes them back, nothing is eroded."""
    H, W = upper_img.shape[1:3]
    h, w = H >> box_factor, W >> box_factor
    M, M_inv, valid = part_transforms(keypoints, img_h=img_h or H, patch_w=w, patch_h=h, pad_x=pad_x)
    return _routing_inputs(upper_img, lower_img, upper_mask, lower_mask, M, M, valid, valid, M_inv, valid,
                           False, (h, w))


MIX_SWAPS = ("upper", "lower", "full")


def mix_warp_inputs(
    person_upper_img: torch.Tensor,  # [B, H, W, 3] target person's own clothes, [0, 1]
    person_lower_img: torch.Tensor,
    person_upper_mask: torch.Tensor,  # [B, H, W, 1]
    person_lower_mask: torch.Tensor,
    garment_upper_img: torch.Tensor,  # [B, H, W, 3] garment provider's clothes
    garment_lower_img: torch.Tensor,
    garment_upper_mask: torch.Tensor,
    garment_lower_mask: torch.Tensor,
    person_keypoints: torch.Tensor,  # [B, 18, 3] target pose (denorm geometry)
    garment_keypoints: torch.Tensor,  # [B, 18, 3]
    swap: str = "upper",
    box_factor: int = 2,
    img_h: Optional[int] = None,
    pad_x: float = 32.0,
) -> dict:
    """Operands of the snapshot grid's cross-pair routing
    (`pasta_gan_tpu/data/warp.py:route_patches_mix_batch`): each garment
    region comes from the person (self-routed with the person's M) or the
    garment provider (normalized with the garment's M): "upper" takes the
    provider's top and keeps the person's pants, "lower" the reverse, "full"
    takes both.  Everything re-projects with the person's M_inv; masks of
    parts 0-5 are eroded and the 4 hand masks are composited, as on the
    try-on route."""
    if swap not in MIX_SWAPS:
        raise ValueError(f"swap must be one of {MIX_SWAPS}, got {swap!r}")
    sources, patch_hw = _region_sources(
        person_upper_img, person_lower_img, person_upper_mask, person_lower_mask, garment_upper_img,
        garment_lower_img, garment_upper_mask, garment_lower_mask, person_keypoints, garment_keypoints,
        swap in ("upper", "full"), swap in ("lower", "full"), box_factor, img_h, pad_x, knee_fallbacks=True)
    return _routing_inputs(*sources, True, patch_hw)


def _denorm(srcs: torch.Tensor, r: dict, denorm: str):
    """The DENORM step of a route: (group images [B, G, 3, H, W], hand masks
    [B, n_hands, H, W]) from the planar 4-channel patches `srcs`."""
    args = (srcs, r["minv_denorm"], r["valid_denorm"], r["frame_hw"], r["groups"], r["erode_parts"],
            r["hand_parts"])
    if denorm == "fused":
        return composite(*args)
    if denorm == "separate":
        return composite_reference(*args, warp=denorm_warp)
    raise ValueError(f"denorm must be one of {DENORM_ROUTES}, got {denorm!r}")


def _route(r: dict, denorm: str, out=RoutedPatches):
    """One `norm_warp` launch, then the `denorm` route; the fields of `out`
    (a NamedTuple type), each built only when `out` has it."""
    patches = norm_warp(r["src_u"], r["src_l"], r["minv_norm"], r["valid_norm"], r["n_upper"], r["patch_hw"])
    g_imgs, hands = _denorm(patches, r, denorm)
    n = r["n_upper"]
    fields = dict(
        norm_img=lambda: _stack_ch(patches[:, :n, 0:3]),
        norm_img_lower=lambda: _stack_ch(patches[:, n:, 0:3]),
        denorm_upper_img=lambda: g_imgs[:, 0].permute(0, 2, 3, 1),
        denorm_lower_img=lambda: g_imgs[:, 1].permute(0, 2, 3, 1),
        M_invs=lambda: r["M_invs"],
        denorm_hand_masks=lambda: hands[..., None],
        norm_clothes_masks=lambda: _stack_ch(patches[:, :n, 3:4].expand(-1, -1, 3, -1, -1)),
        norm_clothes_masks_lower=lambda: _stack_ch(patches[:, n:, 3:4].expand(-1, -1, 3, -1, -1)),
        valid=lambda: r["valid"],
    )
    return out(**{k: fields[k]() for k in out._fields})


def route_patches_batch(*args, denorm: str = "fused", **kwargs) -> RoutedPatches:
    """Training-path self-routing (arguments of `self_warp_inputs`): one
    `norm_warp` call for the whole batch, then the `denorm` route."""
    return _route(self_warp_inputs(*args, **kwargs), denorm)


def route_patches_transfer_batch(*args, denorm: str = "fused", **kwargs) -> RoutedPatches:
    """Unpaired try-on routing (arguments of `transfer_warp_inputs`): one
    `norm_warp` call for the whole batch, then the `denorm` route."""
    return _route(transfer_warp_inputs(*args, **kwargs), denorm)


def route_patches_mix_batch(*args, denorm: str = "fused", **kwargs) -> RoutedPatches:
    """Cross-pair routing of the snapshot try-on grid (arguments of
    `mix_warp_inputs`): one `norm_warp` call for the whole batch, then the
    `denorm` route."""
    return _route(mix_warp_inputs(*args, **kwargs), denorm)


# ------------------------------------------------------------ released-256 (V19)


class RoutedPatchesV19(NamedTuple):
    norm_img: torch.Tensor  # [B, h, w, 30] parts 0-5 from the garment, 6-9 from the person
    norm_pose: torch.Tensor  # [B, h, w, 30] the per-part warped stickmen
    denorm_upper_img: torch.Tensor  # [B, H, W, 3]
    denorm_lower_img: torch.Tensor  # [B, H, W, 3]


def v19_warp_inputs(
    garment_upper_img: torch.Tensor,  # [B, H, W, 3] garment person's upper clothes, [0, 1]
    garment_upper_mask: torch.Tensor,  # [B, H, W, 1]
    garment_pose: torch.Tensor,  # [B, H, W, 3] garment person's stickman, [0, 1]
    person_lower_img: torch.Tensor,  # [B, H, W, 3] target person's own lower clothes
    person_lower_mask: torch.Tensor,  # [B, H, W, 1]
    person_pose: torch.Tensor,  # [B, H, W, 3] target person's stickman
    garment_keypoints: torch.Tensor,  # [B, 18, 3]
    person_keypoints: torch.Tensor,  # [B, 18, 3]
    box_factor: int = 2,
    img_h: Optional[int] = None,
    pad_x: float = 32.0,
) -> dict:
    """Geometry and kernel operands of the released-256 test routing
    (`pasta_gan_tpu/data/warp.py:route_patches_v19_single`):

    * parts 0-5 normalize the garment's image, mask and stickman with the
      garment's M; parts 6-9 the person's own lower clothes, mask and
      stickman with the person's M.  Each source is one 8-channel frame
      (image, mask, stickman, a zero pad), so one `norm_warp` launch at C = 8
      serves all 10 parts;
    * every part re-projects with the person's M_inv and the person's
      validity; masks of parts 0-5 are 5x5-eroded; there are no hand parts."""
    H, W = garment_upper_img.shape[1:3]
    h, w = H >> box_factor, W >> box_factor
    L = LOWER_PART_START
    kw = dict(img_h=img_h or H, patch_w=w, patch_h=h, pad_x=pad_x, knee_fallbacks=True)
    Mg, _, valid_g = part_transforms(garment_keypoints, **kw)
    Mp, Mp_inv, valid_p = part_transforms(person_keypoints, **kw)
    pad = torch.zeros_like(garment_upper_mask[..., :1])

    def frame(img, mask, pose):
        return torch.cat([img, mask[..., :1], pose, pad], dim=-1).float().contiguous()

    return dict(
        src_u=frame(garment_upper_img, garment_upper_mask, garment_pose),
        src_l=frame(person_lower_img, person_lower_mask, person_pose),
        minv_norm=inv3x3(torch.cat([Mg[:, :L], Mp[:, L:]], dim=1)).contiguous(),
        valid_norm=torch.cat([valid_g[:, :L], valid_p[:, L:]], dim=1).float().contiguous(),
        n_upper=L,
        patch_hw=(h, w),
        minv_denorm=inv3x3(Mp_inv).contiguous(),
        valid_denorm=valid_p.float().contiguous(),
        frame_hw=(H, W),
        groups=(0,) * L + (1,) * (NUM_PARTS - L),
        erode_parts=tuple(p < L for p in range(NUM_PARTS)),
        hand_parts=(),
    )


def route_patches_v19_batch(*args, denorm: str = "fused", **kwargs) -> RoutedPatchesV19:
    """Released-256 test routing (arguments of `v19_warp_inputs`): one
    `norm_warp` call at C = 8 for the whole batch, then the `denorm` route
    on the image and mask channels."""
    r = v19_warp_inputs(*args, **kwargs)
    patches = norm_warp(r["src_u"], r["src_l"], r["minv_norm"], r["valid_norm"], r["n_upper"], r["patch_hw"])
    g_imgs, _ = _denorm(patches[:, :, 0:4].contiguous(), r, denorm)
    return RoutedPatchesV19(
        norm_img=_stack_ch(patches[:, :, 0:3]),
        norm_pose=_stack_ch(patches[:, :, 4:7]),
        denorm_upper_img=g_imgs[:, 0].permute(0, 2, 3, 1),
        denorm_lower_img=g_imgs[:, 1].permute(0, 2, 3, 1),
    )


# ------------------------------------------------------------------- 512x320

# The 512 test path routes the lower garment through parts {0 (torso), 6..9
# (legs)} (the reference's `if ii == 0 or ii >= 6`).
LOWER_PARTS_512 = (0, 6, 7, 8, 9)
CHANGE_REGIONS = ("fullbody", "upperbody", "lowerbody")


class RoutedPatches512(NamedTuple):
    norm_img: torch.Tensor  # [B, h, w, 30] the 10 parts of the upper source x 3ch (part-major)
    norm_img_lower: torch.Tensor  # [B, h, w, 15] parts {0, 6..9} of the lower source x 3ch
    denorm_upper_img: torch.Tensor  # [B, H, W, 3]
    denorm_lower_img: torch.Tensor  # [B, H, W, 3]


def warp_inputs_512(
    person_upper_img: torch.Tensor,  # [B, H, W, 3] person's own upper clothes, [0, 1]
    person_lower_img: torch.Tensor,  # person's own lower clothes
    person_upper_mask: torch.Tensor,  # [B, H, W, 1]
    person_lower_mask: torch.Tensor,
    garment_upper_img: torch.Tensor,  # garment person's upper clothes
    garment_lower_img: torch.Tensor,
    garment_upper_mask: torch.Tensor,
    garment_lower_mask: torch.Tensor,
    person_keypoints: torch.Tensor,  # [B, 18, 3]
    garment_keypoints: torch.Tensor,
    change_region: str = "fullbody",
    box_factor: int = 2,
    img_h: Optional[int] = None,
    pad_x: float = 96.0,
) -> dict:
    """Operands of the 512 region-selectable routing
    (`pasta_gan_tpu/data/warp.py:route_patches_512_batch`):

    * fullbody: upper and lower sources from the garment (garment's M);
      upperbody: upper from the garment, lower from the person (person's M);
      lowerbody: upper from the person, lower from the garment;
    * all 10 parts normalize the upper source, parts {0, 6..9} the lower
      source (appended as 10-14): one `norm_warp` launch, n0 = 10, N = 15;
    * every patch re-projects with the person's M_inv and validity, every
      mask is 5x5-eroded, the upper parts composite into group 0 and the
      lower ones, in the order 0, 6, 7, 8, 9, into group 1; no hand parts.

    The 512 crop has no knee->ankle fallback (`knee_fallbacks=False`)."""
    if change_region not in CHANGE_REGIONS:
        raise ValueError(f"change_region must be one of {CHANGE_REGIONS}, got {change_region!r}")
    sources, patch_hw = _region_sources(
        person_upper_img, person_lower_img, person_upper_mask, person_lower_mask, garment_upper_img,
        garment_lower_img, garment_upper_mask, garment_lower_mask, person_keypoints, garment_keypoints,
        change_region != "lowerbody", change_region != "upperbody", box_factor, img_h, pad_x,
        knee_fallbacks=False)
    return _routing_inputs(*sources, True, patch_hw, lower_parts=LOWER_PARTS_512, erode_all=True, hand_parts=())


def route_patches_512_batch(*args, denorm: str = "fused", **kwargs) -> RoutedPatches512:
    """512 region-selectable routing (arguments of `warp_inputs_512`): one
    `norm_warp` call for the whole batch, then the `denorm` route."""
    return _route(warp_inputs_512(*args, **kwargs), denorm, RoutedPatches512)
