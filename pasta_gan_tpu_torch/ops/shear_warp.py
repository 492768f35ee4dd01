"""Two-pass affine resampling, the ADA pipe's fast warp (counterpart of
`pasta_gan_tpu/ops/shear_warp.py`).

An affine warp factors into two 1-D resampling passes: horizontal over the
source rows, then vertical over the columns of that result.  Within a pass
every line samples at positions that share one slope and differ by a
per-line offset,

    P[line, i] = slope * i + offset[line],

so each pass is a gather along the line (two taps per output) and a
fractional mix done as elementwise math.  The JAX package computes the same
taps with one-hot matmuls and bf16 mantissa splits, a TPU device that keeps
XLA off per-row gathers; on the GPU a gather along the contiguous axis is
the plain form.  Every gather and elementwise op here has derivatives of
every order, so the pipe's R1 penalty differentiates through it twice.

The semantics the JAX code fixes are kept exactly, since they decide which
tap reads what at the edges:

* the slope is NaN-scrubbed and clipped to [-W, W], the offsets scrubbed;
* base = floor(offset), delta = clip(offset - base, 0, 1), m0 = floor(slope*i),
  frx = slope*i - m0; the taps are base + m0 + e and one past it, where
  e = [frx + delta >= 1] and the mix fraction is frx + delta - e;
* a tap reads 0 outside [0, W), and when its window index m0 + k + j_off
  (j_off = W + 1 for slope >= 0, 2W below) leaves [0, 3W + 2);
* a line whose base leaves [-W, 2W] reads 0 throughout;
* per sample the source is transposed when |a01| > |a11| (a rotation near
  90 degrees would make the vertical pass degenerate), and a11 is guarded
  at 1e-6.

Index math is float32 whatever the image dtype; delta, frx and the fraction
take the image's dtype and the mix is float32, as the JAX code's promotion
gives it.  Layout is NCHW, lines along the last axis.
"""

from __future__ import annotations

import torch


def _resample_lines(img: torch.Tensor, slope: torch.Tensor, offsets: torch.Tensor, n_out: int) -> torch.Tensor:
    """1-D affine resample of every line of img [B, C, L, W] along its last
    axis: out[b, c, l, i] = img(b, c, l, slope[b] * i + offsets[b, l]) for
    i in [0, n_out), linear interpolation, constant-zero border.  Returns
    float32 [B, C, L, n_out]."""
    B, C, L, W = img.shape
    dtype = img.dtype
    f32 = dict(dtype=torch.float32, device=img.device)
    slope = torch.nan_to_num(slope.float(), nan=0.0, posinf=float(W), neginf=-float(W)).clamp(-float(W), float(W))
    offsets = torch.nan_to_num(offsets.float(), nan=3.0 * W, posinf=3.0 * W, neginf=-3.0 * W)

    base = torch.floor(offsets)  # [B, L]
    delta = (offsets - base).clamp(0.0, 1.0).to(dtype)
    row_ok = (base >= -float(W)) & (base <= 2.0 * W)
    base_i = base.clamp(-float(W), 2.0 * W).long()
    # the JAX code's [3W + 2] window sits ahead of base for positive slopes
    # and behind it for negative ones
    j_off = torch.where(slope >= 0, W + 1, 2 * W).long()  # [B]

    sxi = slope[:, None] * torch.arange(n_out, **f32)  # [B, n_out]
    m0f = torch.floor(sxi)
    frx = (sxi - m0f).to(dtype)
    m0 = m0f.long()

    fr0 = frx[:, None, :] + delta[:, :, None]  # [B, L, n_out], image dtype
    e = fr0 >= 1.0
    fr = torch.where(e, fr0 - 1.0, fr0)
    k0 = m0[:, None, :] + e.long() + j_off[:, None, None]  # window index of the lower tap
    col0 = base_i[:, :, None] - j_off[:, None, None] + k0  # = base + m0 + e
    Wg = 3 * W + 2

    def tap(k, col):
        ok = (k >= 0) & (k < Wg) & (col >= 0) & (col < W)
        idx = col.clamp(0, W - 1)[:, None].expand(B, C, L, n_out)
        v = torch.gather(img, 3, idx)
        return torch.where(ok[:, None], v, torch.zeros((), dtype=dtype, device=img.device)).float()

    lo, hi = tap(k0, col0), tap(k0 + 1, col0 + 1)
    out = lo * (1.0 - fr)[:, None] + hi * fr[:, None]
    return out * row_ok[:, None, :, None].to(dtype)


def affine_resample_two_pass(img: torch.Tensor, A: torch.Tensor, out_hw) -> torch.Tensor:
    """out[b, :, y, x] = img[b](A[b] @ (x, y, 1)), two 1-D passes (module
    docstring); img [B, C, H, W] square, A [B, 2, 3] dst pixel -> src pixel.
    Constant-zero border, as the exact warp's.  Returns float32 [B, C, Ho, Wo]."""
    B, C, H, W = img.shape
    if H != W:
        raise ValueError(f"the two-pass warp's transpose needs square sources, got {H}x{W}")
    Ho, Wo = out_hw
    A = A.float()
    # transposing the source swaps the rows of A
    use_t = A[:, 0, 1].abs() > A[:, 1, 1].abs()
    Ak = torch.where(use_t[:, None, None], A.flip(1), A)
    src = torch.where(use_t[:, None, None, None], img.transpose(2, 3), img)

    a00, a01, a02 = Ak[:, 0, 0], Ak[:, 0, 1], Ak[:, 0, 2]
    a10, a11, a12 = Ak[:, 1, 0], Ak[:, 1, 1], Ak[:, 1, 2]
    safe_a11 = torch.where(a11.abs() < 1e-6, torch.full_like(a11, 1e-6), a11)

    # pass 1, over the source rows: f(x, Y) = alpha x + beta Y + gamma
    beta = a01 / safe_a11
    alpha = a00 - beta * a10
    gamma = a02 - beta * a12
    rows = torch.arange(H, dtype=torch.float32, device=img.device)
    I1 = _resample_lines(src, alpha, beta[:, None] * rows + gamma[:, None], Wo)  # [B, C, H, Wo]

    # pass 2, over the columns of I1: g(x, y) = a11 y + (a10 x + a12)
    cols = torch.arange(Wo, dtype=torch.float32, device=img.device)
    out_t = _resample_lines(I1.transpose(2, 3).contiguous(), a11, a10[:, None] * cols + a12[:, None], Ho)
    return out_t.transpose(2, 3)
