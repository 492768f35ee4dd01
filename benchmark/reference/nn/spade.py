"""SPADE texture-refinement blocks (counterpart of `pasta_gan_tpu/nn/spade.py`).

`SpadeConv2dLayer` is act-then-conv (the activation runs before the
convolution unless `no_act`), `SpadeNormBlock` is InstanceNorm modulated by
gamma/beta predicted from the denormalized garment features, and
`SpadeResBlock` wires three of them with a gain-0.5 skip.  `feat_multiplier=2`
gives the blocks of the Full generator (upper and lower features concatenated).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.bias_act import activation_funcs, bias_act
from ..ops.conv2d_resample import conv2d_resample
from .layers import Layer, _filter_buffer, _normal_, instance_norm_2d


class SpadeConv2dLayer(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, bias=True, activation="relu",
                 up=1, down=1, resample_filter=(1, 3, 3, 1), conv_clamp=None):
        super().__init__()
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

    def forward(self, x, gain: float = 1.0, no_act: bool = False):
        k = self.kernel_size
        if not no_act:
            act_gain = activation_funcs[self.activation].def_gain * gain
            act_clamp = self.conv_clamp * gain if self.conv_clamp is not None else None
            x = bias_act(x, self.bias, act=self.activation, gain=act_gain, clamp=act_clamp)
        gain_w = 1.0 / math.sqrt(self.in_channels * k * k)
        w = self.weight * gain_w
        resample = self.up > 1 or self.down > 1
        return conv2d_resample(
            x.to(self.compute_dtype),
            w.to(self.compute_dtype),
            f=self.resample_filter if resample else None,
            up=self.up, down=self.down, padding=k // 2, flip_weight=(self.up == 1),
        )


class SpadeNormBlock(nn.Module):
    """InstanceNorm(x) * (1 + gamma) + beta, gamma/beta from the denorm features."""

    def __init__(self, in_channels, norm_channels):
        super().__init__()
        self.conv_mlp = SpadeConv2dLayer(in_channels, norm_channels, 3, bias=False)
        self.conv_gamma = SpadeConv2dLayer(norm_channels, norm_channels, 3, bias=False)
        self.conv_beta = SpadeConv2dLayer(norm_channels, norm_channels, 3, bias=False)

    def forward(self, x, denorm_feats):
        normalized = instance_norm_2d(x)
        actv = F.relu(self.conv_mlp(denorm_feats, no_act=True))
        gamma = self.conv_gamma(actv, no_act=True)
        beta = self.conv_beta(actv, no_act=True)
        return normalized * (1 + gamma) + beta


class SpadeResBlock(nn.Module):
    def __init__(self, in_channels, out_channels, resolution=128, feat_multiplier=1, conv_clamp=None,
                 feat_site=True):
        super().__init__()
        feat_channels = (128 if resolution == 128 else 64) * feat_multiplier
        self.conv = SpadeConv2dLayer(in_channels, in_channels, 3, bias=False, conv_clamp=conv_clamp)
        self.spade_skip = SpadeNormBlock(feat_channels, in_channels)
        self.skip = SpadeConv2dLayer(in_channels, out_channels, 1, bias=False, conv_clamp=conv_clamp)
        self.spade0 = SpadeNormBlock(feat_channels, in_channels)
        self.conv0 = SpadeConv2dLayer(in_channels, out_channels, 3, bias=False, conv_clamp=conv_clamp)
        self.spade1 = SpadeNormBlock(feat_channels, out_channels)
        self.conv1 = SpadeConv2dLayer(out_channels, out_channels, 3, bias=False, conv_clamp=conv_clamp)

    def forward(self, x, denorm_feat):
        x = self.conv(x, no_act=True)
        y = self.skip(self.spade_skip(x, denorm_feat), gain=math.sqrt(0.5))
        h = self.conv0(self.spade0(x, denorm_feat))
        h = self.conv1(self.spade1(h, denorm_feat), gain=math.sqrt(0.5))
        return y + h
