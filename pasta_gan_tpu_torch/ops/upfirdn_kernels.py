"""2x up / 2x down FIR resampling ([1,3,3,1]) as two CUDA kernels that are
each other's gradient.

Counterpart of `pasta_gan_tpu/ops/pallas_upfirdn.py` (`_up2_kernel`,
`_down2_kernel`), NCHW here.  Per axis, zeros outside the input:

* `up2(x, extend)`:  y[2u] = x[u-1]/4 + 3x[u]/4, y[2u+1] = 3x[u]/4 + x[u+1]/4
  over output indices -extend .. 2L-1+extend.  extend=0 is
  `upsample2d(x, [1,3,3,1])` (padding (2,1), gain 4); extend=1 is the pre-FIR
  of `conv2d_resample(up=2, k=3, padding=1)` (padding (3,2)).
* `down2(x, pad)`:  y[u] = (x[2u-pad] + 3x[2u+1-pad] + 3x[2u+2-pad] +
  x[2u+3-pad]) / 8.  pad=1 is `downsample2d(x, [1,3,3,1])` and the even
  samples of the 1x1 down-conv's FIR.

In 2-D, up2(extend)^T = 4 down2(pad = 1 - extend) and down2(pad)^T =
1/4 up2(extend = 1 - pad), so each `torch.autograd.Function`'s backward
applies the other Function (scaled through `gain`): forward, backward and
the R1 double backward run on the same two kernels.

`up2_reference` / `down2_reference` are the plain versions (the same
per-axis formula in PyTorch, vertical pass first, in fp32 or wider, one
rounding to the input's type).  A CPU tensor takes the plain version; a CUDA
tensor launches the kernel (`csrc/upfirdn2x.cu`, counted in
`ops/cuda_kernels.py:KERNELS`) or raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .cuda_kernels import DOWN2, UP2, check_tensor, stream_of

KERNEL_DTYPES = (torch.float32, torch.bfloat16)


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


def _launch(kernel, x, out_hw, arg, gain):
    N, C, H, W = x.shape
    dev = x.device
    check_tensor(x, "x", (N, C, H, W), dev, KERNEL_DTYPES)
    y = torch.empty((N, C) + tuple(out_hw), dtype=x.dtype, device=dev)
    if y.numel():
        kernel.launch(x.data_ptr(), y.data_ptr(), int(x.dtype == torch.bfloat16), N * C, H, W, arg,
                      float(gain), stream_of(dev))
    return y


def _up2_apply(x, extend, gain):
    if x.device.type == "cpu":
        return up2_reference(x, extend, gain)
    if x.device.type != "cuda":
        raise ValueError(f"up2 runs on cpu or cuda tensors, got {x.device}")
    _check_args(x, "up2", extend, "extend")
    H, W = x.shape[2:]
    return _launch(UP2, x, (2 * H + 2 * extend, 2 * W + 2 * extend), extend, gain)


def _down2_apply(x, pad, gain):
    if x.device.type == "cpu":
        return down2_reference(x, pad, gain)
    if x.device.type != "cuda":
        raise ValueError(f"down2 runs on cpu or cuda tensors, got {x.device}")
    _check_args(x, "down2", pad, "pad")
    H, W = x.shape[2:]
    if H % 2 or W % 2:
        raise ValueError(f"down2 needs an even height and width, got {tuple(x.shape)}")
    return _launch(DOWN2, x, (H // 2 + pad - 1, W // 2 + pad - 1), pad, gain)


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
