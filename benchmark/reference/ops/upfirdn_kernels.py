"""2x up / 2x down FIR resampling ([1,3,3,1]), plain PyTorch.

A frozen copy of the port's `ops/upfirdn_kernels.py`, where the program
launches `csrc/upfirdn2x.cu` on the card.  Per axis, zeros outside the input:

* `up2(x, extend)`:  y[2u] = x[u-1]/4 + 3x[u]/4, y[2u+1] = 3x[u]/4 + x[u+1]/4
  over output indices -extend .. 2L-1+extend.
* `down2(x, pad)`:  y[u] = (x[2u-pad] + 3x[2u+1-pad] + 3x[2u+2-pad] +
  x[2u+3-pad]) / 8.

up2(extend)^T = 4 down2(pad = 1 - extend) and down2(pad)^T = 1/4 up2(extend
= 1 - pad): each `torch.autograd.Function`'s backward applies the other.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.promote_types(x.dtype, torch.float32)


def _pad_axis(x, dim, before, after):
    """Zero padding of NCHW dim 2 (H) or 3 (W)."""
    return F.pad(x, (before, after) if dim == 3 else (0, 0, before, after))


def _every2(x, dim, start, n):
    """Elements start, start + 2, ... (n of them) along dim."""
    idx = [slice(None)] * x.ndim
    idx[dim] = slice(start, start + 2 * n - 1, 2)
    return x[tuple(idx)]


def _up_axis(x, dim, extend):
    L = x.shape[dim]
    xp = _pad_axis(x, dim, 1, 1)  # xp[k] = x[k - 1]
    a, b = xp.narrow(dim, 0, L + 1), xp.narrow(dim, 1, L + 1)
    odd = a * 0.75 + b * 0.25  # y[2k - 1], k = 0 .. L
    even = a * 0.25 + b * 0.75  # y[2k],     k = 0 .. L
    y = torch.stack([odd, even], dim=dim + 1).flatten(dim, dim + 1)  # y[-1] .. y[2L]
    return y if extend else y.narrow(dim, 1, 2 * L)


def _down_axis(x, dim, pad):
    L = x.shape[dim]
    n = L // 2 + pad - 1
    xp = _pad_axis(x, dim, pad, pad)
    s = [_every2(xp, dim, k, n) for k in range(4)]
    return s[0] * 0.125 + s[1] * 0.375 + s[2] * 0.375 + s[3] * 0.125


def _check_args(x, name, arg, arg_name):
    if x.ndim != 4:
        raise ValueError(f"{name} takes NCHW, got shape {tuple(x.shape)}")
    if arg not in (0, 1):
        raise ValueError(f"{name}: {arg_name} must be 0 or 1, got {arg}")


def up2_reference(x: torch.Tensor, extend: int = 0, gain: float = 1.0) -> torch.Tensor:
    """Plain version of `up2`: [N, C, H, W] -> [N, C, 2H + 2e, 2W + 2e]."""
    _check_args(x, "up2", extend, "extend")
    y = x.to(_compute_dtype(x))
    y = _up_axis(_up_axis(y, 2, extend), 3, extend)
    return (y * gain).to(x.dtype)


def down2_reference(x: torch.Tensor, pad: int = 1, gain: float = 1.0) -> torch.Tensor:
    """Plain version of `down2`: [N, C, H, W] (H, W even) -> [N, C, H/2 + pad - 1, W/2 + pad - 1]."""
    _check_args(x, "down2", pad, "pad")
    if x.shape[2] % 2 or x.shape[3] % 2:
        raise ValueError(f"down2 needs an even height and width, got {tuple(x.shape)}")
    y = x.to(_compute_dtype(x))
    y = _down_axis(_down_axis(y, 2, pad), 3, pad)
    return (y * gain).to(x.dtype)


def _up2_apply(x, extend, gain):
    return up2_reference(x, extend, gain)


def _down2_apply(x, pad, gain):
    return down2_reference(x, pad, gain)


class Up2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, extend, gain):
        ctx.extend, ctx.gain = extend, gain
        return _up2_apply(x.contiguous(), extend, gain)

    @staticmethod
    def backward(ctx, g):
        return Down2.apply(g, 1 - ctx.extend, 4.0 * ctx.gain), None, None


class Down2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pad, gain):
        ctx.pad, ctx.gain = pad, gain
        return _down2_apply(x.contiguous(), pad, gain)

    @staticmethod
    def backward(ctx, g):
        return Up2.apply(g, 1 - ctx.pad, 0.25 * ctx.gain), None, None


def up2(x: torch.Tensor, extend: int = 0, gain: float = 1.0) -> torch.Tensor:
    """2x FIR upsample, differentiable to any order (see the module docstring)."""
    return Up2.apply(x, extend, gain)


def down2(x: torch.Tensor, pad: int = 1, gain: float = 1.0) -> torch.Tensor:
    """2x FIR downsample, differentiable to any order (see the module docstring)."""
    return Down2.apply(x, pad, gain)
