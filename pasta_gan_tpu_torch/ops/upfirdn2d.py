"""upfirdn2d: zero-upsample -> pad/crop -> FIR filter -> downsample, NCHW.

Counterpart of `pasta_gan_tpu/ops/upfirdn2d.py` (itself the reference's
`torch_utils/ops/upfirdn2d.py` contract).  Plain PyTorch: zero insertion is a
reshape + pad, the FIR is a depthwise `conv2d`, downsampling is a strided
slice.  Semantics kept exactly: `flip_filter=False` means convolution (the
filter is flipped before the correlation `conv2d` performs), `setup_filter`
scales by `gain ** (ndim / 2)`, and separable filters run as two 1-D passes,
vertical first, like the JAX package.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

Scaling = Union[int, Sequence[int]]
Padding = Union[int, Sequence[int]]


def _parse_scaling(scaling: Scaling) -> tuple[int, int]:
    if isinstance(scaling, (int, np.integer)):
        scaling = [int(scaling), int(scaling)]
    sx, sy = (int(s) for s in scaling)
    if sx < 1 or sy < 1:
        raise ValueError(f"scaling factors must be >= 1, got {(sx, sy)}")
    return sx, sy


def _parse_padding(padding: Padding) -> tuple[int, int, int, int]:
    if isinstance(padding, (int, np.integer)):
        padding = [int(padding), int(padding)]
    padding = [int(p) for p in padding]
    if len(padding) == 2:
        px, py = padding
        padding = [px, px, py, py]
    px0, px1, py0, py1 = padding
    return px0, px1, py0, py1


def _get_filter_size(f: Optional[torch.Tensor]) -> tuple[int, int]:
    if f is None:
        return 1, 1
    if f.ndim == 1:
        return int(f.shape[0]), int(f.shape[0])
    return int(f.shape[-1]), int(f.shape[0])  # (fw, fh)


def setup_filter(
    f,
    device=None,
    normalize: bool = True,
    flip_filter: bool = False,
    gain: float = 1.0,
    separable: Optional[bool] = None,
) -> torch.Tensor:
    """float32 `[fh, fw]` (non-separable) or `[taps]` (separable) filter."""
    if f is None:
        f = 1
    f = torch.as_tensor(f, dtype=torch.float32, device=device)
    if f.ndim == 0:
        f = f[None]
    if f.ndim not in (1, 2) or f.numel() == 0:
        raise ValueError(f"filter must be 1-D or 2-D and non-empty, got {tuple(f.shape)}")
    if separable is None:
        separable = f.ndim == 1 and f.numel() >= 8
    if f.ndim == 1 and not separable:
        f = torch.outer(f, f)
    if normalize:
        f = f / f.sum()
    if flip_filter:
        f = f.flip(list(range(f.ndim)))
    return f * (gain ** (f.ndim / 2))


def _depthwise_fir(x, f, up, down, padding, flip_filter):
    """Zero-insert by `up`, pad/crop, depthwise-correlate with the (flipped)
    2-D filter `f`, subsample by `down`."""
    upx, upy = up
    downx, downy = down
    px0, px1, py0, py1 = padding
    N, C, H, W = x.shape
    if upx > 1 or upy > 1:
        x = x.reshape(N, C, H, 1, W, 1)
        x = F.pad(x, [0, upx - 1, 0, 0, 0, upy - 1])
        x = x.reshape(N, C, H * upy, W * upx)
    x = F.pad(x, [max(px0, 0), max(px1, 0), max(py0, 0), max(py1, 0)])
    x = x[:, :, max(-py0, 0) : x.shape[2] - max(-py1, 0), max(-px0, 0) : x.shape[3] - max(-px1, 0)]
    if not flip_filter:
        f = f.flip([0, 1])
    w = f.to(x.dtype)[None, None].repeat(C, 1, 1, 1)
    x = F.conv2d(x, w, groups=C)
    return x[:, :, ::downy, ::downx]


def upfirdn2d(
    x: torch.Tensor,
    f: Optional[torch.Tensor],
    up: Scaling = 1,
    down: Scaling = 1,
    padding: Padding = 0,
    flip_filter: bool = False,
    gain: float = 1.0,
) -> torch.Tensor:
    """Pad, upsample, FIR-filter and downsample a batch of NCHW images."""
    if x.ndim != 4:
        raise ValueError(f"expected NCHW, got shape {tuple(x.shape)}")
    upx, upy = _parse_scaling(up)
    downx, downy = _parse_scaling(down)
    px0, px1, py0, py1 = _parse_padding(padding)
    if f is None:
        f = torch.ones((1, 1), dtype=torch.float32, device=x.device)
    if f.ndim == 2:
        if gain != 1:
            f = f * (gain ** (f.ndim / 2))
        return _depthwise_fir(x, f, (upx, upy), (downx, downy), (px0, px1, py0, py1), flip_filter)
    g = gain**0.5
    x = _depthwise_fir(x, (f * g)[:, None], (1, upy), (1, downy), (0, 0, py0, py1), flip_filter)
    return _depthwise_fir(x, (f * g)[None, :], (upx, 1), (downx, 1), (px0, px1, 0, 0), flip_filter)


def filter2d(x, f, padding: Padding = 0, flip_filter=False, gain=1.0):
    """Same-size FIR filtering."""
    px0, px1, py0, py1 = _parse_padding(padding)
    fw, fh = _get_filter_size(f)
    p = (px0 + fw // 2, px1 + (fw - 1) // 2, py0 + fh // 2, py1 + (fh - 1) // 2)
    return upfirdn2d(x, f, padding=p, flip_filter=flip_filter, gain=gain)


def upsample2d(x, f, up: Scaling = 2, padding: Padding = 0, flip_filter=False, gain=1.0):
    """FIR upsampling."""
    upx, upy = _parse_scaling(up)
    px0, px1, py0, py1 = _parse_padding(padding)
    fw, fh = _get_filter_size(f)
    p = (
        px0 + (fw + upx - 1) // 2,
        px1 + (fw - upx) // 2,
        py0 + (fh + upy - 1) // 2,
        py1 + (fh - upy) // 2,
    )
    return upfirdn2d(x, f, up=up, padding=p, flip_filter=flip_filter, gain=gain * upx * upy)


def downsample2d(x, f, down: Scaling = 2, padding: Padding = 0, flip_filter=False, gain=1.0):
    """FIR downsampling."""
    downx, downy = _parse_scaling(down)
    px0, px1, py0, py1 = _parse_padding(padding)
    fw, fh = _get_filter_size(f)
    p = (
        px0 + (fw - downx + 1) // 2,
        px1 + (fw - downx) // 2,
        py0 + (fh - downy + 1) // 2,
        py1 + (fh - downy) // 2,
    )
    return upfirdn2d(x, f, down=down, padding=p, flip_filter=flip_filter, gain=gain)
