"""3x3 homography helpers shared by the routing warps.

`inv3x3` is the same adjugate/determinant formula as
`pasta_gan_tpu/ops/matmul_warp.py:inv3x3`, evaluated in the same order.  It
is deliberately not `torch.linalg.inv`: a different inverse moves sample
coordinates by ulps, and that flips mask pixels next to the saturation
threshold (254.5/255).  Singular input gives inf/nan like any inverse.
"""

from __future__ import annotations

import torch


def inv3x3(M: torch.Tensor) -> torch.Tensor:
    """Batched closed-form inverse of [..., 3, 3] float32 matrices."""
    M = M.float()
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    adj = torch.stack(
        [torch.stack([A, B, C], -1), torch.stack([D, E, F], -1), torch.stack([G, H, I], -1)], -2
    )
    return adj / det[..., None, None]


def warp_coords(Minv: torch.Tensor, out_hw: tuple[int, int]):
    """Source sample coordinates (sx, sy) [..., h, w] of every destination
    pixel for dst->src homographies `Minv` [..., 3, 3] (cv2 convention:
    integer pixel centres, `denom` clamped to 1e-8 where |denom| < 1e-8)."""
    h, w = out_hw
    gy, gx = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=Minv.device),
        torch.arange(w, dtype=torch.float32, device=Minv.device),
        indexing="ij",
    )
    m = Minv[..., None, None].float()  # [..., 3, 3, 1, 1]
    denom = m[..., 2, 0, :, :] * gx + m[..., 2, 1, :, :] * gy + m[..., 2, 2, :, :]
    denom = torch.where(denom.abs() < 1e-8, torch.full_like(denom, 1e-8), denom)
    sx = (m[..., 0, 0, :, :] * gx + m[..., 0, 1, :, :] * gy + m[..., 0, 2, :, :]) / denom
    sy = (m[..., 1, 0, :, :] * gx + m[..., 1, 1, :, :] * gy + m[..., 1, 2, :, :]) / denom
    return sx, sy
