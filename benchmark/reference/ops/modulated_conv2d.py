"""Style-modulated convolution (counterpart of `pasta_gan_tpu/ops/modulated_conv2d.py`).

Scaled-activation form, as in the JAX package: the activations are scaled by
the styles before ONE dense conv with shared weights, and the output by the
demodulation coefficients after it.  The coefficients use the identity

    dcoef[n,o] = rsqrt( sum_i s[n,i]^2 * (sum_k w[o,i,k]^2) + eps )

so no per-sample weight tensor is built.  `prenorm_for_half` reproduces the
fp16/bf16 overflow pre-normalization.  NCHW activations, OIHW weights.
"""

from __future__ import annotations

from typing import Optional

import torch

from .conv2d_resample import conv2d_resample

_HALF = (torch.float16, torch.bfloat16)


def modulated_conv2d(
    x: torch.Tensor,  # [N, I, H, W]
    weight: torch.Tensor,  # [O, I, kh, kw]
    styles: torch.Tensor,  # [N, I]
    noise: Optional[torch.Tensor] = None,  # broadcastable to the output
    up: int = 1,
    down: int = 1,
    padding: int = 0,
    resample_filter: Optional[torch.Tensor] = None,
    demodulate: bool = True,
    flip_weight: bool = True,
    spade_styles: Optional[torch.Tensor] = None,  # [N, I, H, W] spatial styles
    prenorm_for_half: bool = True,
) -> torch.Tensor:
    N = x.shape[0]
    out_channels, in_channels, kh, kw = weight.shape
    if x.shape[1] != in_channels or tuple(styles.shape) != (N, in_channels):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, w {tuple(weight.shape)}, s {tuple(styles.shape)}")

    prenorm = prenorm_for_half and x.dtype in _HALF and demodulate
    if prenorm:
        wmax = weight.abs().amax(dim=(1, 2, 3), keepdim=True)  # per-O
        weight = weight * (1.0 / (in_channels * kh * kw) ** 0.5 / (wmax + 1e-8))
        smax = styles.abs().amax(dim=1, keepdim=True)
        styles = styles / (smax + 1e-8)

    dcoefs = None
    if demodulate:
        w32 = weight.float()
        s32 = styles.float()
        w_sq = (w32 * w32).sum(dim=(2, 3))  # [O, I]
        dcoefs = torch.rsqrt((s32 * s32) @ w_sq.t() + 1e-8)  # [N, O]

    if spade_styles is not None:
        if spade_styles.shape != x.shape:
            raise ValueError(f"spade_styles {tuple(spade_styles.shape)} != x {tuple(x.shape)}")
        x = x * ((spade_styles.to(x.dtype) + styles.to(x.dtype)[:, :, None, None]) * 0.5)
    else:
        x = x * styles.to(x.dtype)[:, :, None, None]

    x = conv2d_resample(
        x, weight, f=resample_filter, up=up, down=down, padding=padding, flip_weight=flip_weight
    )
    if demodulate:
        x = x * dcoefs.to(x.dtype)[:, :, None, None]
    if noise is not None:
        x = x + noise.to(x.dtype)
    return x
