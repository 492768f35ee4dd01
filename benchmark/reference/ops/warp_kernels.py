"""Plain PyTorch versions of the program's three routing kernels.

A frozen copy of the port's `ops/warp_kernels.py` plain versions
(`norm_warp_reference`, `denorm_warp_reference`, `composite_reference`);
`norm_warp`, `denorm_warp` and `composite` are these plain versions on every
device, where the program launches `csrc/norm_warp.cu`, `csrc/denorm_warp.cu`
and `csrc/composite.cu` on the card.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .warp_math import warp_coords

# cv2's `== 255` on uint8 masks, as a float32 threshold.
MASK_SATURATION_THRESHOLD = float(np.float32(254.5 / 255.0))


# --------------------------------------------------------------------- norm


def norm_warp_reference(src0, src1, minv, valid, n0: int, out_hw) -> torch.Tensor:
    """Plain version of `norm_warp`: the bilinear gather of
    `pasta_gan_tpu/data/warp.py:_bilinear_core` (replicate border).  A
    non-finite coordinate gives NaN here, where the kernel (like the TPU
    kernel) squashes it to 0; routed matrices are always finite."""
    B, H, W, C = src0.shape
    N = minv.shape[1]
    sx, sy = warp_coords(minv, out_hw)  # [B, N, h, w]
    sx = sx.clamp(0.0, W - 1)
    sy = sy.clamp(0.0, H - 1)
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = (sx - x0)[..., None]
    fy = (sy - y0)[..., None]
    xi = x0.long().clamp(0, W - 1)
    yi = y0.long().clamp(0, H - 1)
    xj = (xi + 1).clamp(max=W - 1)
    yj = (yi + 1).clamp(max=H - 1)
    frames = torch.stack([src0, src1], dim=1).reshape(-1, C)  # [(B*2*H*W), C]
    sel = (torch.arange(N, device=minv.device) >= n0).long()
    fidx = (torch.arange(B, device=minv.device)[:, None] * 2 + sel[None, :])[..., None, None]

    def tap(yy, xx):
        return frames[(fidx * H + yy) * W + xx]  # [B, N, h, w, C]

    top = tap(yi, xi) * (1 - fx) + tap(yi, xj) * fx
    bot = tap(yj, xi) * (1 - fx) + tap(yj, xj) * fx
    out = top * (1 - fy) + bot * fy
    out = out * valid[:, :, None, None, None]
    return out.permute(0, 1, 4, 2, 3).contiguous()


# ------------------------------------------------------------------- denorm


def denorm_warp_reference(srcs, minv, valid, out_hw, border: str = "constant") -> torch.Tensor:
    """Plain version of `denorm_warp`: the bilinear gather of `_bilinear_core`,
    times the validity gate.  With the constant border a coordinate outside
    (-1, size), or not finite (the TPU kernel's squash), samples 0; with the
    replicate border a non-finite coordinate gives NaN here, where the kernel
    squashes it to 0."""
    B, N, C, Hs, Ws = srcs.shape
    H, W = out_hw
    sx, sy = warp_coords(minv, out_hw)  # [B, N, H, W]
    if border == "constant":
        inside = (sx > -1.0) & (sx < Ws) & (sy > -1.0) & (sy < Hs)  # False for NaN
        sx, sy = sx.clamp(-1.0, float(Ws)), sy.clamp(-1.0, float(Hs))
        planes, off = F.pad(srcs, (1, 1, 1, 1)), 1  # indices into the zero-padded patch
    elif border == "replicate":
        inside = None
        sx, sy = sx.clamp(0.0, Ws - 1.0), sy.clamp(0.0, Hs - 1.0)
        planes, off = srcs, 0
    else:
        raise ValueError(f"border must be 'constant' or 'replicate', got {border!r}")
    Hp, Wp = planes.shape[-2:]
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = (sx - x0).reshape(B * N, 1, H * W)
    fy = (sy - y0).reshape(B * N, 1, H * W)
    xi = (x0.long() + off).clamp(0, Wp - 1).reshape(B * N, 1, H * W)
    yi = (y0.long() + off).clamp(0, Hp - 1).reshape(B * N, 1, H * W)
    xj = (xi + 1).clamp(max=Wp - 1)
    yj = (yi + 1).clamp(max=Hp - 1)
    flat = planes.reshape(B * N, C, Hp * Wp)

    def tap(yy, xx):
        return torch.gather(flat, 2, (yy * Wp + xx).expand(B * N, C, H * W))

    top = tap(yi, xi) * (1 - fx) + tap(yi, xj) * fx
    bot = tap(yj, xi) * (1 - fx) + tap(yj, xj) * fx
    out = top * (1 - fy) + bot * fy
    if inside is not None:
        out = torch.where(inside.reshape(B * N, 1, H * W), out, torch.zeros_like(out))
    return out.reshape(B, N, C, H, W) * valid[:, :, None, None, None]


# ---------------------------------------------------------------- composite


def erode_binary(mask: torch.Tensor, size: int = 5) -> torch.Tensor:
    """cv2.erode with its default (+inf) border on a binary mask [..., H, W]:
    a min-pool with SAME padding (max_pool2d pads with -inf)."""
    shape = mask.shape
    m = mask.reshape((-1, 1) + tuple(shape[-2:]))
    m = -F.max_pool2d(-m, size, stride=1, padding=size // 2)
    return m.reshape(shape)


def composite_reference(srcs, minv, valid, out_hw, groups, erode_parts, hand_parts, warp=denorm_warp_reference):
    """The separate-pass pipeline of `pasta_gan_tpu/data/warp.py:route_patches_single`
    (gated warp -> threshold -> erode_binary -> select chain), op for op.

    With the plain warp (the default) it is the plain version of `composite`;
    with `warp=denorm_warp` it is the separate-pass denorm route, whose warp
    runs the `denorm_warp` kernel on CUDA tensors."""
    B, N = srcs.shape[:2]
    H, W = out_hw
    dn = warp(srcs, minv, valid, out_hw)
    thresh = torch.tensor(MASK_SATURATION_THRESHOLD, dtype=torch.float32, device=srcs.device)
    sat = (dn[:, :, 3] >= thresh).to(srcs.dtype)  # [B, N, H, W]
    ero = [p for p in range(N) if erode_parts[p]]
    if ero:
        sat = sat.clone()
        sat[:, ero] = erode_binary(sat[:, ero])
    vmask = valid[:, :, None, None]
    n_groups = max(groups) + 1
    acc = [torch.zeros((B, 3, H, W), dtype=srcs.dtype, device=srcs.device) for _ in range(n_groups)]
    for p in range(N):
        v = (sat[:, p] * vmask[:, p])[:, None]  # [B, 1, H, W]
        acc[groups[p]] = dn[:, p, 0:3] * v + acc[groups[p]] * (1 - v)
    hands = [sat[:, p] * vmask[:, p] for p in hand_parts]
    hands = torch.stack(hands, dim=1) if hands else srcs.new_zeros((B, 0, H, W))
    return torch.stack(acc, dim=1), hands


norm_warp = norm_warp_reference
denorm_warp = denorm_warp_reference
composite = composite_reference
