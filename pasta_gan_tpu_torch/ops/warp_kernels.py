"""The three routing kernels of the try-on paths and their plain PyTorch versions.

* `norm_warp` (csrc/norm_warp.cu) replaces `pasta_gan_tpu/ops/pallas_warp.py:_norm_kernel`:
  full frames -> planar per-part patches, bilinear, replicate border, 4 or 8
  channels.
* `composite` (csrc/composite.cu) replaces `pallas_warp.py:_composite_kernel`:
  patches -> frame (constant-zero border), mask >= 254.5/255, 5x5 erosion of
  flagged parts, later-parts-overwrite composite into group planes, hand masks.
* `denorm_warp` (csrc/denorm_warp.cu) replaces `pallas_warp.py:_warp_kernel`:
  patches -> one full-frame plane per part, constant or replicate border.  It
  is the first pass of the separate-pass denorm route, `composite_reference`
  with `warp=denorm_warp`, which the routes take with `denorm="separate"`.

`composite_live_tiles` is the composite kernel's exact skip test in
PyTorch: which (part, strip) pairs it computes.

Each wrapper runs its plain version for tensors on the CPU, and for CUDA
tensors launches its kernel or raises; there is no fallback.  The plain
versions (`norm_warp_reference`, `composite_reference`,
`denorm_warp_reference`) are the same math as the JAX package's CPU paths
(`_warp_parts_gather`, the separate-pass composite of
`route_patches_single`, `warp_parts_pallas`); the CPU tests hold them against
JAX and `chip_smoke.py` holds the kernels against them on the card.

The kernels are declared, built and counted in `ops/cuda_kernels.py`
(`KERNELS["norm_warp"]`, `KERNELS["composite"]`, `KERNELS["denorm_warp"]`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .cuda_kernels import COMPOSITE, DENORM_WARP, NORM_WARP, check_tensor, stream_of
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


def norm_warp(src0, src1, minv, valid, n0: int, out_hw) -> torch.Tensor:
    """NORM warps of B samples x N parts in one launch.

    src0, src1: [B, H, W, C] float32 NHWC frames, C = 4 or 8 (parts p < n0
    sample src0, the rest src1); minv: [B, N, 3, 3] dst->src homographies
    (inverses of the frame->patch M); valid: [B, N] float32 gate.  Returns
    planar [B, N, C, h, w] float32."""
    if src0.device.type == "cpu":
        return norm_warp_reference(src0, src1, minv, valid, n0, out_hw)
    if src0.device.type != "cuda":
        raise ValueError(f"norm_warp runs on cpu or cuda tensors, got {src0.device}")
    B, H, W, C = src0.shape
    N = minv.shape[1]
    h, w = out_hw
    dev = src0.device
    if C not in (4, 8):
        raise ValueError(f"norm_warp needs 4- or 8-channel frames, got {C}")
    check_tensor(src0, "src0", (B, H, W, C), dev)
    check_tensor(src1, "src1", (B, H, W, C), dev)
    if src0.data_ptr() % 16 or src1.data_ptr() % 16:
        raise ValueError("norm_warp reads each pixel's channels as 16-byte vectors: src0 and src1 must be 16-byte aligned")
    check_tensor(minv, "minv", (B, N, 3, 3), dev)
    check_tensor(valid, "valid", (B, N), dev)
    out = torch.empty((B, N, C, h, w), dtype=torch.float32, device=dev)
    NORM_WARP.launch(
        src0.data_ptr(), src1.data_ptr(), minv.data_ptr(), valid.data_ptr(), out.data_ptr(),
        B, N, n0, H, W, h, w, C, stream_of(dev),
    )
    return out


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


def denorm_warp(srcs, minv, valid, out_hw, border: str = "constant") -> torch.Tensor:
    """DENORM warps of B samples x N parts in one launch.

    srcs: [B, N, C, Hs, Ws] float32 planar patches; minv: [B, N, 3, 3]
    frame->patch homographies (inverses of the patch->frame M); valid: [B, N]
    float32 gate (an invalid part gives an all-zero plane); border:
    "constant" (zero outside the patch) or "replicate" (the sample clamps to
    the patch).  Returns planar [B, N, C, H, W] float32."""
    if border not in ("constant", "replicate"):
        raise ValueError(f"border must be 'constant' or 'replicate', got {border!r}")
    if srcs.device.type == "cpu":
        return denorm_warp_reference(srcs, minv, valid, out_hw, border)
    if srcs.device.type != "cuda":
        raise ValueError(f"denorm_warp runs on cpu or cuda tensors, got {srcs.device}")
    B, N, C, Hs, Ws = srcs.shape
    H, W = out_hw
    dev = srcs.device
    check_tensor(srcs, "srcs", (B, N, C, Hs, Ws), dev)
    check_tensor(minv, "minv", (B, N, 3, 3), dev)
    check_tensor(valid, "valid", (B, N), dev)
    out = torch.empty((B, N, C, H, W), dtype=torch.float32, device=dev)
    DENORM_WARP.launch(
        srcs.data_ptr(), minv.data_ptr(), valid.data_ptr(), out.data_ptr(),
        B, N, C, Hs, Ws, H, W, int(border == "replicate"), stream_of(dev),
    )
    return out


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


# The composite kernel's unit of skipping: each warp's strip of 2 rows x 32
# columns of a 32x32 output tile (csrc/composite.cu: ROWS x TILE).
COMPOSITE_STRIP = (2, 32)


def composite_live_tiles(minv, valid, out_hw, patch_hw) -> torch.Tensor:
    """[B, N, ceil(H / th), ceil(W / tw)] bool, (th, tw) = COMPOSITE_STRIP: the
    (part, strip) pairs the `composite` kernel computes; it skips the others,
    whose strip no pixel of the part's sample reaches.

    The kernel's test (`corner_terms`, `misses_support`), operation for
    operation in fp32: the tile's corner pixels go through the frame->patch
    homography; a tile is skipped only when the terms are finite, the
    denominator keeps one sign well away from 0 at all four corners (so the
    tile's image is the convex quad of the corner images) and all four
    corner images lie beyond one edge of the support (-1, Ws) x (-1, Hs) by
    more than a bound on the rounding of these and the kernel's per-pixel
    coordinates.  An invalid part is live nowhere."""
    B, N = minv.shape[:2]
    H, W = out_hw
    Hs, Ws = patch_hw
    m = minv.reshape(B, N, 9).float()[:, :, :, None, None, None]  # [B, N, 9, 1, 1, 1]
    th, tw = COMPOSITE_STRIP
    x0 = torch.arange(0, W, tw, device=minv.device)
    y0 = torch.arange(0, H, th, device=minv.device)
    x1 = torch.clamp(x0 + tw, max=W) - 1
    y1 = torch.clamp(y0 + th, max=H) - 1
    # corner c = (c & 1 ? x1 : x0, c & 2 ? y1 : y0): [ty, tx, 4]
    X = torch.stack([x0, x1, x0, x1], -1).float()[None, :, :].expand(len(y0), len(x0), 4)
    Y = torch.stack([y0, y0, y1, y1], -1).float()[:, None, :].expand(len(y0), len(x0), 4)
    p0, p1, p3, p4, p6, p7 = m[:, :, 0] * X, m[:, :, 1] * Y, m[:, :, 3] * X, m[:, :, 4] * Y, m[:, :, 6] * X, m[:, :, 7] * Y
    nx = p0 + p1 + m[:, :, 2]
    ny = p3 + p4 + m[:, :, 5]
    d = p6 + p7 + m[:, :, 8]
    sx, sy = nx / d, ny / d
    a = (p0.abs() + p1.abs() + m[:, :, 2].abs()).amax(-1)
    b = (p3.abs() + p4.abs() + m[:, :, 5].abs()).amax(-1)
    e = (p6.abs() + p7.abs() + m[:, :, 8].abs()).amax(-1)
    d_min = d.abs().amin(-1)
    sx_abs, sy_abs = sx.abs().amax(-1), sy.abs().amax(-1)
    ku, big = 2.0 ** -16, 3.4e38
    ok = (a <= big) & (b <= big) & (e <= big) & ((d > 0).all(-1) | (d < 0).all(-1)) & (d_min > 1e-6 + ku * e)
    mx = ku * ((a + sx_abs * e) / d_min + sx_abs) + 1e-5
    my = ku * ((b + sy_abs * e) / d_min + sy_abs) + 1e-5
    miss = ok & ((sx.amax(-1) <= -1.0 - mx) | (sx.amin(-1) >= Ws + mx)
                 | (sy.amax(-1) <= -1.0 - my) | (sy.amin(-1) >= Hs + my))
    return (valid != 0)[:, :, None, None] & ~miss


def composite(srcs, minv, valid, out_hw, groups, erode_parts, hand_parts):
    """Fused denorm -> saturate -> erode -> composite.

    srcs: [B, N, 4, h, w] float32 planar patches (mask last); minv: [B, N, 3, 3]
    frame->patch homographies (inverses of the patch->frame M); valid: [B, N]
    float32; groups / erode_parts: per part; hand_parts: ascending part ids.
    Returns (group_imgs [B, n_groups, 3, H, W], hand_masks [B, n_hands, H, W])."""
    if srcs.device.type == "cpu":
        return composite_reference(srcs, minv, valid, out_hw, groups, erode_parts, hand_parts)
    if srcs.device.type != "cuda":
        raise ValueError(f"composite runs on cpu or cuda tensors, got {srcs.device}")
    B, N, C, Hs, Ws = srcs.shape
    H, W = out_hw
    dev = srcs.device
    n_groups = max(groups) + 1
    if C != 4 or N > 32 or n_groups > 2 or len(groups) != N or len(erode_parts) != N:
        raise ValueError("composite takes 4-channel patches, <= 32 parts and <= 2 groups")
    if list(hand_parts) != sorted(set(hand_parts)):
        raise ValueError(f"hand_parts must be ascending and unique, got {hand_parts}")
    check_tensor(srcs, "srcs", (B, N, 4, Hs, Ws), dev)
    check_tensor(minv, "minv", (B, N, 3, 3), dev)
    check_tensor(valid, "valid", (B, N), dev)
    group_bits = sum(1 << p for p in range(N) if groups[p] == 1)
    erode_bits = sum(1 << p for p in range(N) if erode_parts[p])
    hand_bits = sum(1 << p for p in hand_parts)
    g_out = torch.empty((B, n_groups, 3, H, W), dtype=torch.float32, device=dev)
    h_out = torch.empty((B, len(hand_parts), H, W), dtype=torch.float32, device=dev)
    COMPOSITE.launch(
        srcs.data_ptr(), minv.data_ptr(), valid.data_ptr(), g_out.data_ptr(),
        h_out.data_ptr() if hand_parts else None,
        B, N, Hs, Ws, H, W, n_groups, group_bits, erode_bits, hand_bits, len(hand_parts),
        MASK_SATURATION_THRESHOLD, stream_of(dev),
    )
    return g_out, h_out
