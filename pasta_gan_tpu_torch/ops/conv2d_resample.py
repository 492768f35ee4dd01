"""2-D convolution with optional FIR up/downsampling, NCHW with OIHW weights.

Counterpart of `pasta_gan_tpu/ops/conv2d_resample.py`, with the same
decomposition: padding is computed once against the resampled grid, an
upsampling conv runs upfirdn2d(up, gain=up**2) then the dense conv, a
downsampling conv runs the FIR first and then a strided dense conv.
`flip_weight=True` means correlation (what `conv2d` computes); False flips
the kernel spatially, i.e. a true convolution.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import upfirdn2d as _u


def _conv2d(x, w, stride=1, padding=(0, 0, 0, 0), groups=1, flip_weight=True):
    if not flip_weight:
        w = w.flip([2, 3])
    px0, px1, py0, py1 = padding
    if px0 == px1 and py0 == py1 and px0 >= 0 and py0 >= 0:
        return F.conv2d(x, w.to(x.dtype), stride=stride, padding=(py0, px0), groups=groups)
    x = F.pad(x, [px0, px1, py0, py1])
    return F.conv2d(x, w.to(x.dtype), stride=stride, groups=groups)


def conv2d_resample(
    x: torch.Tensor,
    w: torch.Tensor,
    f: Optional[torch.Tensor] = None,
    up: int = 1,
    down: int = 1,
    padding=0,
    groups: int = 1,
    flip_weight: bool = True,
    flip_filter: bool = False,
) -> torch.Tensor:
    if x.ndim != 4 or w.ndim != 4:
        raise ValueError(f"expected NCHW input and OIHW weight, got {tuple(x.shape)}, {tuple(w.shape)}")
    if not (isinstance(up, int) and up >= 1 and isinstance(down, int) and down >= 1):
        raise ValueError(f"up/down must be ints >= 1, got {up}, {down}")
    fw, fh = _u._get_filter_size(f)
    px0, px1, py0, py1 = _u._parse_padding(padding)

    if up > 1:
        px0 += (fw + up - 1) // 2
        px1 += (fw - up) // 2
        py0 += (fh + up - 1) // 2
        py1 += (fh - up) // 2
    if down > 1:
        px0 += (fw - down + 1) // 2
        px1 += (fw - down) // 2
        py0 += (fh - down + 1) // 2
        py1 += (fh - down) // 2

    if up > 1:
        x = _u.upfirdn2d(x, f, up=up, padding=(px0, px1, py0, py1), gain=up**2, flip_filter=flip_filter)
        x = _conv2d(x, w, groups=groups, flip_weight=flip_weight)
        if down > 1:
            x = _u.upfirdn2d(x, f, down=down, flip_filter=flip_filter)
        return x
    if down > 1:
        x = _u.upfirdn2d(x, f, padding=(px0, px1, py0, py1), flip_filter=flip_filter)
        return _conv2d(x, w, stride=down, groups=groups, flip_weight=flip_weight)
    return _conv2d(x, w, padding=(px0, px1, py0, py1), groups=groups, flip_weight=flip_weight)
