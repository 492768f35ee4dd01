"""StyleGAN2 discriminator (counterpart of `pasta_gan_tpu/nn/discriminator.py`).

NCHW.  Conditioning: `c` is the 512-d style code from the generator's style
encoder, embedded by an internal MappingNetwork (z_dim 0, no broadcast) and
projected against the epilogue's output.  The epilogue runs in float32 (the
reference's `networks.py:1057`).  Parameter names are the reference's
state_dict names (`b256.fromrgb.weight`, `b4.fc.weight`, `mapping.embed.weight`).

`architecture` is the reference's: "resnet" (the default, the training
path's), "skip" or "orig".  A resnet block's `skip` is a 1x1 down-conv whose
FIR is the `down2` kernel's (ops/conv2d_resample.py); `conv1`'s 3x3
down-conv filters at full resolution on the plain path.  A skip block reads
the image through its own `fromrgb` and hands the next block the image
downsampled by `downsample2d` (the `down2` kernel); the skip epilogue adds
a `fromrgb` of the 4x4 image.  "orig" has neither skips nor an image
pyramid.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..ops.upfirdn2d import downsample2d
from .layers import Conv2dLayer, FullyConnectedLayer, Layer, MinibatchStdLayer, _filter_buffer
from .mapping import MappingNetwork

ARCHITECTURES = ("orig", "skip", "resnet")


class DiscriminatorBlock(nn.Module):
    """Down block (reference `networks.py:916-996`)."""

    def __init__(self, in_channels, tmp_channels, out_channels, resolution, img_channels, architecture="resnet",
                 activation="lrelu", resample_filter=(1, 3, 3, 1), conv_clamp=None):
        super().__init__()
        if architecture not in ARCHITECTURES:
            raise ValueError(f"architecture must be one of {ARCHITECTURES}, got {architecture!r}")
        self.in_channels, self.resolution, self.architecture = in_channels, resolution, architecture
        if in_channels == 0 or architecture == "skip":
            self.fromrgb = Conv2dLayer(img_channels, tmp_channels, 1, activation=activation,
                                       conv_clamp=conv_clamp)
        if architecture == "resnet":
            self.skip = Conv2dLayer(tmp_channels, out_channels, 1, bias=False, down=2,
                                    resample_filter=resample_filter)
        self.conv0 = Conv2dLayer(tmp_channels, tmp_channels, 3, activation=activation, conv_clamp=conv_clamp)
        self.conv1 = Conv2dLayer(tmp_channels, out_channels, 3, activation=activation, down=2,
                                 resample_filter=resample_filter, conv_clamp=conv_clamp)
        if architecture == "skip":
            _filter_buffer(self, resample_filter)

    def forward(self, x: Optional[torch.Tensor], img: Optional[torch.Tensor]):
        """Returns (x, img): img is the next block's image (skip) or None."""
        if self.in_channels == 0 or self.architecture == "skip":
            dt = self.fromrgb.compute_dtype
            y = self.fromrgb(img.to(dt))
            x = x + y if x is not None else y
            img = downsample2d(img, self.resample_filter) if self.architecture == "skip" else None
        if self.architecture == "resnet":
            y = self.skip(x, gain=math.sqrt(0.5))
            x = self.conv0(x)
            x = self.conv1(x, gain=math.sqrt(0.5))
            return y + x, img
        return self.conv1(self.conv0(x)), img


class DiscriminatorEpilogue(nn.Module):
    """mbstd + conv + FCs + cmap projection (reference `networks.py:1026-1080`), float32."""

    def __init__(self, in_channels, cmap_dim, resolution, img_channels=3, architecture="resnet",
                 mbstd_group_size=4, mbstd_num_channels=1, activation="lrelu", conv_clamp=None):
        super().__init__()
        self.cmap_dim, self.architecture = cmap_dim, architecture
        if architecture == "skip":
            self.fromrgb = Conv2dLayer(img_channels, in_channels, 1, activation=activation)
        self.mbstd = MinibatchStdLayer(mbstd_group_size, mbstd_num_channels) if mbstd_num_channels > 0 else None
        self.conv = Conv2dLayer(in_channels + mbstd_num_channels, in_channels, 3, activation=activation,
                                conv_clamp=conv_clamp)
        self.fc = FullyConnectedLayer(in_channels * resolution**2, in_channels, activation=activation)
        self.out = FullyConnectedLayer(in_channels, 1 if cmap_dim == 0 else cmap_dim)

    def forward(self, x, img, cmap):
        x = x.float()
        if self.architecture == "skip":
            x = x + self.fromrgb(img.float())
        if self.mbstd is not None:
            x = self.mbstd(x)
        x = self.conv(x)
        x = self.fc(x.flatten(1))
        x = self.out(x)
        if self.cmap_dim > 0:
            x = (x * cmap.float()).sum(dim=1, keepdim=True) * (1.0 / math.sqrt(self.cmap_dim))
        return x


class Discriminator(nn.Module):
    """Full discriminator (reference `networks.py:1085-1139`)."""

    def __init__(self, c_dim=512, img_resolution=256, img_channels=3, architecture="resnet", channel_base=32768,
                 channel_max=512, conv_clamp=None, cmap_dim=None, mbstd_group_size=4, mbstd_num_channels=1,
                 dtype=torch.float32):
        super().__init__()
        self.c_dim, self.img_resolution, self.architecture = c_dim, img_resolution, architecture
        self.channel_base, self.channel_max = channel_base, channel_max
        self.block_resolutions = [2**i for i in range(int(math.log2(img_resolution)), 2, -1)]
        cmap_dim = self.channels(4) if cmap_dim is None else cmap_dim
        if c_dim == 0:
            cmap_dim = 0
        for res in self.block_resolutions:
            in_channels = self.channels(res) if res < img_resolution else 0
            setattr(self, f"b{res}", DiscriminatorBlock(
                in_channels, self.channels(res), self.channels(res // 2), resolution=res,
                img_channels=img_channels, architecture=architecture, conv_clamp=conv_clamp))
        if c_dim > 0:
            self.mapping = MappingNetwork(z_dim=0, c_dim=c_dim, w_dim=cmap_dim, num_ws=None)
        self.b4 = DiscriminatorEpilogue(self.channels(4), cmap_dim=cmap_dim, resolution=4,
                                        img_channels=img_channels, architecture=architecture,
                                        mbstd_group_size=mbstd_group_size,
                                        mbstd_num_channels=mbstd_num_channels, conv_clamp=conv_clamp)
        # the epilogue keeps float32 whatever the compute dtype
        self._epilogue_layers = set(self.b4.modules())
        self.set_dtype(dtype)

    def channels(self, res: int) -> int:
        return min(self.channel_base // res, self.channel_max)

    def set_dtype(self, dtype: torch.dtype) -> "Discriminator":
        """Compute dtype of the blocks and the mapping (parameters stay float32)."""
        self.dtype = dtype
        for m in self.modules():
            if isinstance(m, Layer):
                m.compute_dtype = torch.float32 if m in self._epilogue_layers else dtype
        return self

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> "Discriminator":
        for m in self.modules():
            if isinstance(m, Layer):
                m.reset_parameters(generator)
        return self

    def forward(self, img: torch.Tensor, c: Optional[torch.Tensor]) -> torch.Tensor:
        """img [N, 3, H, W] (NCHW), c [N, c_dim] -> logits [N, 1] float32."""
        x = None
        for res in self.block_resolutions:
            x, img = getattr(self, f"b{res}")(x, img)
        cmap = self.mapping(None, c)[0] if self.c_dim > 0 else None
        return self.b4(x, img, cmap)
