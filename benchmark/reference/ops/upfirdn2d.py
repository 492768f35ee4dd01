"""upfirdn2d: zero-upsample -> pad/crop -> FIR filter -> downsample, NCHW.

Counterpart of `pasta_gan_tpu/ops/upfirdn2d.py` (itself the reference's
`torch_utils/ops/upfirdn2d.py` contract).  Plain PyTorch: zero insertion is a
reshape + pad, the FIR is a depthwise `conv2d`, downsampling is a strided
slice.  Semantics kept exactly: `flip_filter=False` means convolution (the
filter is flipped before the correlation `conv2d` performs), `setup_filter`
scales by `gain ** (ndim / 2)`, and separable filters run as two 1-D passes,
vertical first, like the JAX package.

Three calls of the training and serving paths are the 2x [1,3,3,1] cases
that the `up2` / `down2` kernels compute (ops/upfirdn_kernels.py);
`fir2x_route` is the one place that decides which calls go there.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from .upfirdn_kernels import down2, up2

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


_CANONICAL_TAPS = torch.tensor([1.0, 3.0, 3.0, 1.0]) / 8.0


def is_canonical_filter(f: Optional[torch.Tensor]) -> bool:
    """True for `setup_filter([1, 3, 3, 1])`: the 4-tap 1-D filter or its 4x4
    outer product, normalized, before any gain.  The verdict is kept on the
    tensor (with its version), so a filter on the card is read back once,
    not at every call."""
    if f is None or tuple(f.shape) not in ((4,), (4, 4)):
        return False
    cached = getattr(f, "_canonical_fir", None)  # (tensor version, verdict)
    if cached is None or cached[0] != f._version:
        t = _CANONICAL_TAPS if f.ndim == 1 else torch.outer(_CANONICAL_TAPS, _CANONICAL_TAPS)
        cached = (f._version, bool(torch.allclose(f.detach().cpu().float(), t, rtol=0.0, atol=1e-7)))
        f._canonical_fir = cached
    return cached[1]


def fir2x_route(f, up, down, padding, gain):
    """Which kernel computes `upfirdn2d(x, f, up, down, padding, gain=gain)`:
    ("up2", extend), ("down2", pad) or None (the plain depthwise path).

    * up 2, padding (2,1) per axis, gain 4: `upsample2d` -> up2(extend=0);
    * up 2, padding (3,2) per axis, gain 4: the up-conv pre-FIR -> up2(extend=1);
    * down 2, padding (1,1) per axis, gain 1: `downsample2d` and the 1x1
      down-conv -> down2(pad=1).
    The filter is [1,3,3,1] in every case (it is symmetric, so `flip_filter`
    does not matter)."""
    if not is_canonical_filter(f):
        return None
    if up == (2, 2) and down == (1, 1) and gain == 4:
        if padding == (2, 1, 2, 1):
            return "up2", 0
        if padding == (3, 2, 3, 2):
            return "up2", 1
    if up == (1, 1) and down == (2, 2) and gain == 1 and padding == (1, 1, 1, 1):
        return "down2", 1
    return None


def _correlate(x, f, padding):
    """Pad (negative: crop) NCHW x by (px0, px1, py0, py1) and correlate each
    channel with the 2-D filter f [fh, fw]."""
    px0, px1, py0, py1 = padding
    x = F.pad(x, [max(px0, 0), max(px1, 0), max(py0, 0), max(py1, 0)])
    x = x[:, :, max(-py0, 0) : x.shape[2] - max(-py1, 0), max(-px0, 0) : x.shape[3] - max(-px1, 0)]
    C = x.shape[1]
    return F.conv2d(x, f.to(x.dtype)[None, None].repeat(C, 1, 1, 1), groups=C)


class DepthwiseFIR(torch.autograd.Function):
    """`_correlate` whose gradient is `_correlate` again, with the flipped
    filter and the complementary padding (fw-1-px0, fw-1-px1, fh-1-py0,
    fh-1-py1): derivatives of every order stay one depthwise convolution.
    (PyTorch's own double backward of a grouped convolution runs one
    convolution per channel, which made R1 through D's 3x3 down-convs take
    seconds at batch 32.)  The filter is a constant."""

    @staticmethod
    def forward(ctx, x, f, padding):
        ctx.save_for_backward(f)
        ctx.padding = padding
        return _correlate(x, f, padding)

    @staticmethod
    def backward(ctx, g):
        (f,) = ctx.saved_tensors
        fh, fw = f.shape
        px0, px1, py0, py1 = ctx.padding
        adjoint_padding = (fw - 1 - px0, fw - 1 - px1, fh - 1 - py0, fh - 1 - py1)
        return DepthwiseFIR.apply(g, f.flip([0, 1]), adjoint_padding), None, None


def _depthwise_fir(x, f, up, down, padding, flip_filter):
    """Zero-insert by `up`, pad/crop, depthwise-correlate with the (flipped)
    2-D filter `f`, subsample by `down`."""
    upx, upy = up
    downx, downy = down
    N, C, H, W = x.shape
    if upx > 1 or upy > 1:
        x = x.reshape(N, C, H, 1, W, 1)
        x = F.pad(x, [0, upx - 1, 0, 0, 0, upy - 1])
        x = x.reshape(N, C, H * upy, W * upx)
    if not flip_filter:
        f = f.flip([0, 1])
    x = DepthwiseFIR.apply(x, f.detach(), tuple(padding))
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
    route = fir2x_route(f, (upx, upy), (downx, downy), (px0, px1, py0, py1), gain)
    if route is not None:
        kind, arg = route
        return up2(x, extend=arg) if kind == "up2" else down2(x, pad=arg)
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
