"""Fused bias + activation + gain + clamp (counterpart of `pasta_gan_tpu/ops/bias_act.py`).

Plain PyTorch: the whole chain is elementwise and memory-light next to the
convolutions that produce its input.  What matters is the semantics: the
9-entry activation table with per-activation default gains (`def_gain`), the
optional alpha, and the symmetric output clamp.  Layout is NCHW, so the
default bias axis is 1.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

_SQRT2 = math.sqrt(2.0)


@dataclasses.dataclass(frozen=True)
class ActivationSpec:
    func: Callable  # (x, alpha) -> y
    def_alpha: float
    def_gain: float


activation_funcs: dict[str, ActivationSpec] = {
    "linear": ActivationSpec(lambda x, a: x, 0.0, 1.0),
    "relu": ActivationSpec(lambda x, a: F.relu(x), 0.0, _SQRT2),
    "lrelu": ActivationSpec(lambda x, a: F.leaky_relu(x, a), 0.2, _SQRT2),
    "tanh": ActivationSpec(lambda x, a: torch.tanh(x), 0.0, 1.0),
    "sigmoid": ActivationSpec(lambda x, a: torch.sigmoid(x), 0.0, 1.0),
    "elu": ActivationSpec(lambda x, a: F.elu(x), 0.0, 1.0),
    "selu": ActivationSpec(lambda x, a: F.selu(x), 0.0, 1.0),
    "softplus": ActivationSpec(lambda x, a: F.softplus(x), 0.0, 1.0),
    "swish": ActivationSpec(lambda x, a: torch.sigmoid(x) * x, 0.0, _SQRT2),
}


def bias_act(
    x: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    dim: int = 1,
    act: str = "linear",
    alpha: Optional[float] = None,
    gain: Optional[float] = None,
    clamp: Optional[float] = None,
) -> torch.Tensor:
    """Add bias along `dim`, apply `act`, scale by `gain`, clamp to ±`clamp`."""
    spec = activation_funcs[act]
    alpha_v = float(spec.def_alpha if alpha is None else alpha)
    gain_v = float(spec.def_gain if gain is None else gain)

    if b is not None:
        if b.ndim != 1:
            raise ValueError(f"bias must be 1D, got shape {tuple(b.shape)}")
        ax = dim % x.ndim
        if b.shape[0] != x.shape[ax]:
            raise ValueError(f"bias size {b.shape[0]} != x.shape[{ax}] = {x.shape[ax]}")
        shape = [1] * x.ndim
        shape[ax] = -1
        x = x + b.to(x.dtype).reshape(shape)

    x = spec.func(x, alpha_v)
    if gain_v != 1.0:
        x = x * gain_v
    if clamp is not None:
        if clamp < 0:
            raise ValueError("clamp must be non-negative")
        x = x.clamp(-clamp, clamp)
    return x
