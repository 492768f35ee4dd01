"""Style-modulated convolution (counterpart of `pasta_gan_tpu/ops/modulated_conv2d.py`).

Scaled-activation form, as in the JAX package: the activations are scaled by
the styles before ONE dense conv with shared weights, and the output by the
demodulation coefficients after it.  The coefficients use the identity

    dcoef[n,o] = rsqrt( sum_i s[n,i]^2 * (sum_k w[o,i,k]^2) + eps )

so no per-sample weight tensor is built.  `prenorm_for_half` reproduces the
fp16/bf16 overflow pre-normalization.  NCHW activations, OIHW weights.

int8 serving (`quant`, ops/quant.py): the modulated activation is quantized
at `quant_site` (an `ActScale`; styles make per-sample ranges, so the caller
owns the site).  A stride-1 conv runs int8 as it is; the up=2 3x3 conv of an
input of at least 32 rows folds its [1,3,3,1] FIR into a 6x6 kernel
(`fold_up_weights`) run int8 with input dilation 2 and padding 3, as the JAX
package does.  Every other case (the low-resolution up-convs) stays float,
and so does the float path's up-conv, which keeps its upfirdn + conv route.
The int8 weight is packed once into `weight_cache` (an `Int8WeightCache`,
keyed on `weight_source`, the parameter `weight` derives from), which an
int8 caller must give.
"""

from __future__ import annotations

from typing import Optional

import torch

from .conv2d_resample import conv2d_resample
from .quant import Int8WeightCache, fold_up_weights, int8_conv2d, is_int8, pack_weight

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
    quant: Optional[str] = None,  # int8 serving mode (ops/quant.py)
    quant_site=None,  # the ActScale that quantizes the modulated tensor
    weight_cache: Optional[Int8WeightCache] = None,  # the int8 weight, built once (required with quant)
    weight_source: Optional[torch.Tensor] = None,  # the parameter `weight` derives from (weight_cache's key)
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

    q = quant if is_int8(quant) and quant_site is not None else None
    fold = (
        up == 2 and down == 1 and not flip_weight and resample_filter is not None
        and kh == 3 and kw == 3 and padding == 1 and tuple(resample_filter.shape) == (4, 4)
        and x.shape[2] >= 32  # below, the 6x6 fold outweighs the upfirdn intermediate it replaces
    )
    if q is not None and (fold or (up == 1 and down == 1)):
        def build():
            if fold:
                return pack_weight(fold_up_weights(weight, resample_filter, gain=4.0), ((3, 3), (3, 3)), 1, 2)
            return pack_weight(weight, ((padding, padding), (padding, padding)), flip_weight=flip_weight)

        if weight_cache is None or weight_source is None:
            raise ValueError("an int8 modulated conv takes its packed weight from weight_cache, keyed on weight_source")
        f = (resample_filter.data_ptr(), resample_filter._version) if fold else None
        w8 = weight_cache.get(weight_source, (q, weight.dtype, prenorm, fold, flip_weight, padding, f), build)
        pads = (3,) * 4 if fold else (padding,) * 4
        x = int8_conv2d(quant_site.quantize(x, q), w8, padding=pads, lhs_dilation=2 if fold else 1, out_dtype=x.dtype)
    else:
        x = conv2d_resample(
            x, weight, f=resample_filter, up=up, down=down, padding=padding, flip_weight=flip_weight
        )
    if demodulate:
        x = x * dcoefs.to(x.dtype)[:, :, None, None]
    if noise is not None:
        x = x + noise.to(x.dtype)
    return x
