"""Pose and style encoders (counterpart of `pasta_gan_tpu/nn/encoders.py`).

Submodule names follow the reference state_dict: `model.<i>` for the
Sequential stacks, `feat_enc.<i>` for the retain-feature branch.
"""

from __future__ import annotations

import torch
from torch import nn

from .layers import Conv2dLayer, DenseNorm, FullyConnectedLayer, SelfAttention


class ConstEncoderNetwork(nn.Module):
    """Pose(+retain) image -> the 4x4 feature map feeding the first synthesis
    block; channel schedule 64,128,256,256,256,512,512 at n_downsampling=6."""

    def __init__(self, input_nc, output_nc=512, ngf=64, n_downsampling=6):
        super().__init__()
        mult_ins = [1, 2, 4, 4, 4, 8]
        mult_outs = [2, 4, 4, 4, 8, 8]
        layers = [Conv2dLayer(input_nc, ngf, 1)]
        for i in range(n_downsampling):
            layers.append(Conv2dLayer(ngf * mult_ins[i], ngf * mult_outs[i], 3, down=2))
        self.model = nn.Sequential(*layers)
        # Reduced configurations only: a 1x1 projection aligns the last
        # stage's channels with the synthesis pyramid's channels(4).
        last_nc = ngf * mult_outs[n_downsampling - 1]
        self.proj = Conv2dLayer(last_nc, output_nc, 1) if last_nc != output_nc else None

    def forward(self, x):
        x = self.model(x)
        return self.proj(x) if self.proj is not None else x


class FeatureEncoder(nn.Module):
    """The reference's deep downsampling encoder (`networks.py:506-524`; the
    JAX package's `nn/encoders.py:FeatureEncoder`): a 1x1 stem to `ngf`
    channels, then `n_downsampling` stride-2 3x3 convs, channel schedule
    128, 256, 256, 512, 512, 512, 512 at ngf 64.  No generator of the
    registry builds it.  `output_nc` is kept for the reference's signature;
    the schedule sets the output width."""

    def __init__(self, input_nc, output_nc=512, ngf=64, n_downsampling=7):
        super().__init__()
        mult_ins = [1, 2, 4, 4, 8, 8, 8]
        mult_outs = [2, 4, 4, 8, 8, 8, 8]
        self.model = nn.Sequential(
            Conv2dLayer(input_nc, ngf, 1),
            *[Conv2dLayer(ngf * mult_ins[i], ngf * mult_outs[i], 3, down=2) for i in range(n_downsampling)])

    def forward(self, x):
        return self.model(x)


class RetainFeatureEncoder(nn.ModuleList):
    """The `feat_enc` branch: 4 convs over the retain image yielding skip
    features at resolutions /1, /2, /4, /8."""

    def __init__(self, ngf=64):
        super().__init__([Conv2dLayer(3, ngf, 3)]
                         + [Conv2dLayer(ngf, ngf, 3, down=2) for _ in range(3)])

    def forward(self, x):
        feats = []
        for layer in self:
            x = layer(x)
            feats.append(x)
        return feats


class StyleEncoderNetworkV16(nn.Module):
    """Patch stack -> 512-d style code, plus the retain skip features.

    `x`: [N, input_nc, h, w] patch stack; `const_input`: [N, 3, H, W] retain image.
    Returns (style [N, output_nc], feats at /1, /2, /4, /8)."""

    use_attention = False

    def __init__(self, input_nc, output_nc=512, ngf=64, extra_convs=3):
        super().__init__()
        self.feat_enc = RetainFeatureEncoder(ngf)
        mult_ins = [1, 2, 4]
        mult_outs = [2, 4, 8]
        layers = [Conv2dLayer(input_nc, ngf, 1)]
        for i in range(3):
            if self.use_attention and i == 2:
                layers.append(SelfAttention(ngf * mult_ins[i]))
            layers.append(DenseNorm(ngf * mult_ins[i], ngf * mult_ins[i]))
            layers.append(Conv2dLayer(ngf * mult_ins[i], ngf * mult_outs[i], 3, down=2))
        for _ in range(extra_convs):
            layers.append(DenseNorm(ngf * 8, ngf * 8))
            layers.append(Conv2dLayer(ngf * 8, ngf * 8, 3))
        self.model = nn.Sequential(*layers)
        self.fc = FullyConnectedLayer(output_nc, output_nc)

    def forward(self, x, const_input):
        feats = self.feat_enc(const_input)
        x = self.model(x)
        x = x.mean(dim=(2, 3))  # AdaptiveAvgPool2d(1)
        return self.fc(x), feats


class StyleEncoderNetwork(StyleEncoderNetworkV16):
    """The V1 style encoder (reference `networks.py:647-698`): V16's with a
    `SelfAttention` before the third DenseNorm, inside the same Sequential, so
    the later indices shift by one (`model.5` is the attention)."""

    use_attention = True
