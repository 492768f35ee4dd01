"""Equalized-LR building blocks (counterpart of `pasta_gan_tpu/nn/layers.py`).

NCHW activations, OIHW conv weights, fp32 parameters with a compute dtype
(`compute_dtype`, float32 or bfloat16).  Equalized learning rate as in the
JAX package: parameters are drawn N(0, 1) (divided by `lr_multiplier` for FC
layers) and scaled at run time by `lr_multiplier / sqrt(fan_in)`.  Parameter
names are the reference state_dict names.

`reset_parameters(generator)` draws every parameter from an explicit
`torch.Generator`.

int8 serving (ops/quant.py): a `Conv2dLayer` built with `quant_site=True`
owns an activation site and, once its `quant` is an int8 mode, runs its conv
int8: at stride 1 as it is, and a down=2 conv as the float FIR pre-pass
(padding k//2 + 1) followed by an int8 stride-2 conv of the filtered tensor,
quantized at this layer's site.  Given a `QuantizedActivation` (a quantize
shared with other convs) it runs int8 on it.  A stride-1 `ResBlock`
quantizes its input once, at its own site, for its skip and conv0.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.bias_act import activation_funcs, bias_act
from ..ops.conv2d_resample import conv2d_resample
from ..ops.quant import ActScale, QuantizedActivation, QuantMode, int8_conv2d, is_int8
from ..ops.upfirdn2d import setup_filter, upfirdn2d


def normalize_2nd_moment(x: torch.Tensor, dim: int = -1, eps: float = 1e-8) -> torch.Tensor:
    """PixelNorm."""
    return x * torch.rsqrt(x.square().mean(dim=dim, keepdim=True) + eps)


def instance_norm_2d(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm2d(affine=False) over NCHW, computed in float32."""
    x32 = x.float()
    mean = x32.mean(dim=(2, 3), keepdim=True)
    var = (x32 - mean).square().mean(dim=(2, 3), keepdim=True)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


class Layer(QuantMode, nn.Module):
    """Base: a compute dtype, an int8 serving mode and a seeded parameter reset."""

    compute_dtype: torch.dtype = torch.float32

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        raise NotImplementedError


def _normal_(p: torch.Tensor, generator, scale: float = 1.0) -> None:
    with torch.no_grad():
        p.normal_(0.0, 1.0, generator=generator)
        if scale != 1.0:
            p.mul_(scale)


def _filter_buffer(module: nn.Module, taps: Sequence[float]) -> None:
    module.register_buffer("resample_filter", setup_filter(list(taps)), persistent=False)


class FullyConnectedLayer(Layer):
    """Equalized-LR linear; weight [out, in]."""

    def __init__(self, in_features, out_features, bias=True, activation="linear", lr_multiplier=1.0, bias_init=0.0):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.activation = activation
        self.lr_multiplier = lr_multiplier
        self.bias_init = bias_init
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        _normal_(self.weight, generator, 1.0 / self.lr_multiplier)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.fill_(self.bias_init)

    def forward(self, x):
        w = self.weight.to(self.compute_dtype) * (self.lr_multiplier / math.sqrt(self.in_features))
        x = x.to(self.compute_dtype) @ w.t()
        b = self.bias
        if b is not None and self.lr_multiplier != 1.0:
            b = b * self.lr_multiplier
        return bias_act(x, b, dim=-1, act=self.activation)


class Conv2dLayer(Layer):
    """Equalized-LR conv + FIR resample + bias_act; `quant_site` gives it the
    activation site of int8 serving (see the module docstring)."""

    def __init__(self, in_channels, out_channels, kernel_size, bias=True, activation="linear",
                 up=1, down=1, resample_filter=(1, 3, 3, 1), conv_clamp=None, quant_site=False):
        super().__init__()
        self.act_scale = ActScale() if quant_site else None
        self.in_channels, self.out_channels, self.kernel_size = in_channels, out_channels, kernel_size
        self.activation, self.up, self.down, self.conv_clamp = activation, up, down, conv_clamp
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None
        _filter_buffer(self, resample_filter)
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        _normal_(self.weight, generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x, gain: float = 1.0):
        """`x` may be a `QuantizedActivation` (int8 modes, stride 1)."""
        k = self.kernel_size
        q = self.quant if is_int8(self.quant) else None
        if isinstance(x, QuantizedActivation):
            if q is None or self.up != 1 or self.down != 1:
                raise ValueError("a quantized input needs an int8 mode and a stride-1 conv")
            x = self._int8(x, q)
        elif q is not None and self.act_scale is not None and self.up == 1 and self.down in (1, 2):
            x = self._int8(x, q)
        else:
            ws = (self.weight * (1.0 / math.sqrt(self.in_channels * k * k))).to(self.compute_dtype)
            resample = self.up > 1 or self.down > 1
            x = conv2d_resample(
                x.to(self.compute_dtype), ws, f=self.resample_filter if resample else None,
                up=self.up, down=self.down, padding=k // 2, flip_weight=(self.up == 1),
            )
        act_gain = activation_funcs[self.activation].def_gain * gain
        act_clamp = self.conv_clamp * gain if self.conv_clamp is not None else None
        return bias_act(x, self.bias, act=self.activation, gain=act_gain, clamp=act_clamp)

    def _int8(self, x, q):
        """The conv of int8 serving: the fp32 gain-scaled weight quantized per
        output channel, the output in the compute dtype."""
        k = self.kernel_size
        w = self.weight * (1.0 / math.sqrt(self.in_channels * k * k))
        dt = self.compute_dtype
        if self.down == 1:
            xq = x if isinstance(x, QuantizedActivation) else self.act_scale.quantize(x, q)
            return int8_conv2d(xq, w, padding=(k // 2,) * 4, out_dtype=dt)
        fw = self.resample_filter.shape[-1]
        p = (k // 2 + (fw - 1) // 2, k // 2 + (fw - 2) // 2) * 2
        xf = upfirdn2d(x.to(dt), self.resample_filter, padding=p)
        return int8_conv2d(self.act_scale.quantize(xf, q), w, stride=2, out_dtype=dt)


class ResBlock(QuantMode, nn.Module):
    """Residual block with gain-0.5 skip; 3x3 convs (the reference ignores its
    kernel_size argument)."""

    def __init__(self, in_channels, out_channels, activation="linear", up=1, down=1,
                 resample_filter=(1, 3, 3, 1), conv_clamp=None, quant_site=False):
        super().__init__()
        # int8: a stride-1 block quantizes x once here for skip and conv0; a
        # down block's skip and conv0 filter x first, each at its own site
        shared = quant_site and up == 1 and down == 1
        self.act_scale = ActScale() if shared else None
        common = dict(up=up, down=down, resample_filter=resample_filter, conv_clamp=conv_clamp,
                      quant_site=quant_site and not shared)
        self.skip = Conv2dLayer(in_channels, out_channels, 1, bias=False, **common)
        self.conv0 = Conv2dLayer(in_channels, out_channels, 3, activation=activation, **common)
        self.conv1 = Conv2dLayer(out_channels, out_channels, 3, activation=activation,
                                 resample_filter=resample_filter, conv_clamp=conv_clamp, quant_site=quant_site)

    def forward(self, x):
        if is_int8(self.quant) and self.act_scale is not None:
            x = self.act_scale.quantize(x.to(self.conv1.compute_dtype), self.quant)
        y = self.skip(x, gain=math.sqrt(0.5))
        x = self.conv0(x)
        x = self.conv1(x, gain=math.sqrt(0.5))
        return y + x


class MinibatchStdLayer(nn.Module):
    """Minibatch standard deviation, NCHW (reference `networks.py:1000-1022`).

    Groups are strided over the batch: sample i's statistics come from
    {i mod N/G + g N/G}; the statistic is appended as the last channels."""

    def __init__(self, group_size: Optional[int] = 4, num_channels: int = 1):
        super().__init__()
        self.group_size, self.num_channels = group_size, num_channels

    def forward(self, x):
        N, C, H, W = x.shape
        G = min(self.group_size, N) if self.group_size is not None else N
        F_ = self.num_channels
        y = x.reshape(G, N // G, F_, C // F_, H, W).float()
        y = y - y.mean(dim=0)
        y = y.square().mean(dim=0)
        y = (y + 1e-8).sqrt()
        y = y.mean(dim=(2, 3, 4)).to(x.dtype)  # [N/G, F]
        y = y.reshape(N // G, F_, 1, 1).repeat(G, 1, H, W)
        return torch.cat([x, y], dim=1)


class DenseNorm(Layer):
    """Linear over channels + InstanceNorm + LeakyReLU(0.01) (the reference's
    `Dense`; plain torch-style Linear parameters, not equalized-LR)."""

    def __init__(self, in_channels, out_channels):
        super().__init__()
        self.linear = nn.Linear(in_channels, out_channels)
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        _normal_(self.linear.weight, generator, 1.0 / math.sqrt(self.linear.in_features))
        with torch.no_grad():
            self.linear.bias.zero_()

    def forward(self, x):
        dt = self.compute_dtype
        w = self.linear.weight.to(dt)[:, :, None, None]
        x = F.conv2d(x.to(dt), w, self.linear.bias.to(dt))
        return F.leaky_relu(instance_norm_2d(x), 0.01)


class SelfAttention(Layer):
    """Spatial self-attention with max-pooled phi/g."""

    def __init__(self, channels):
        super().__init__()
        self.channels = channels
        self.theta = nn.Conv2d(channels, channels // 8, 1, bias=False)
        self.phi = nn.Conv2d(channels, channels // 8, 1, bias=False)
        self.g = nn.Conv2d(channels, channels // 2, 1, bias=False)
        self.o = nn.Conv2d(channels // 2, channels, 1, bias=False)
        self.gamma = nn.Parameter(torch.zeros(()))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        for conv in (self.theta, self.phi, self.g, self.o):
            _normal_(conv.weight, generator, 1.0 / math.sqrt(max(conv.in_channels, 1)))  # channels 0: an empty layer
        with torch.no_grad():
            self.gamma.zero_()

    def forward(self, x):
        dt = self.compute_dtype
        x = x.to(dt)
        N, C, H, W = x.shape
        ch = self.channels

        def conv(m, t):
            return F.conv2d(t, m.weight.to(dt))

        theta = conv(self.theta, x).flatten(2).transpose(1, 2)  # [N, HW, ch/8]
        phi = F.max_pool2d(conv(self.phi, x), 2).flatten(2)  # [N, ch/8, HW/4]
        g = F.max_pool2d(conv(self.g, x), 2).flatten(2).transpose(1, 2)  # [N, HW/4, ch/2]
        beta = torch.softmax((theta @ phi).float(), dim=-1).to(dt)
        o = (beta @ g).transpose(1, 2).reshape(N, ch // 2, H, W)
        return self.gamma.to(dt) * conv(self.o, o) + x
